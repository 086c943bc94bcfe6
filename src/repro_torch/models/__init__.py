"""Decoder model of the port (dense GQA family): config, parameters,
layers and the prefill/decode entry points."""
