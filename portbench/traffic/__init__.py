"""Traffic kinds: one general generator each, ``<kind>.py``, driven by the
parameters a cell's ``workloads/<cell>.json`` gives it."""
