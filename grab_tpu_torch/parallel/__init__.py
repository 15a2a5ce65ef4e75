"""Data parallelism over several GPUs: the -n N group submit.

The reference is one SPMD program over a device mesh; here every shard
device runs its own lane of plain PyTorch calls on its own stream
(``scan_step.shard_devices``, ``scan_pipeline.DeviceScanner``'s lanes).
The packer layout is untouched, only submission is grouped, so -n N
output is byte-identical to -n 1.
"""
