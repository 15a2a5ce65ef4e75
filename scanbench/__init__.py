"""The benchmark of grab_tpu_torch: recursive scans through its scan
server (run.py, harness.py), with the corpus generators, traffic mixes,
metric readers and the plain reference it needs."""
