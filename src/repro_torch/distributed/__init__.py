"""The port's mesh side: the sharded recycle ledger (``ledger``) over the
data axis as a ``torch.distributed`` process group (``compat``,
``repro_torch.launch.mesh``). Model parallelism is not ported yet."""
