"""ZeRO layout and the compressed wires of the port (``deepspeed_tpu/parallel``)."""
