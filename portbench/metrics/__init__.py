"""Per-layer metrics: one reader each, ``<name>.py``, or ``<stem>.py`` for
every metric named ``<stem>.<anything>``.  A reader's ``read(summary)``
returns the number, or None where the run gave it nothing to read; the
harness then leaves the metric out.  ``summary`` holds ``net`` (the
reference's reading of the config), ``batch``, ``window`` (``seconds``,
``images``: images whose answers reached the host in it, ``dispatch_s``:
each request's time in the entry) and ``trace`` (``trace.reduce``'s
result over the traced stretch, with its ``forwards`` and ``images``)."""
