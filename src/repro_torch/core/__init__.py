"""Horovod-style data parallelism and the parameter-server baseline."""
