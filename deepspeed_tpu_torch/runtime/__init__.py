"""Training runtime of the port (counterpart of ``deepspeed_tpu/runtime``):
config, engine, optimizer schedules, loss scaling, synthetic data."""
