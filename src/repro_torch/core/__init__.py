"""The per-instance loss ledger: the numpy reference (``history``) and the
device-resident tensor version (``device_ledger``)."""
