"""Command-line tools of the port: the demo/benchmark CLI (``demo``), the
BASELINE configs 1-3 harness (``configs_bench``) and the multi-process
scaling harness (``multihost_bench``)."""
