"""Range rules beyond ``inputs.py``'s: one each, ``<rule>.py``, found by the
name a configuration gives under ``"ranges"``.  A rule's ``ranges(net)``
takes the reference's reading of the config and returns what
``inputs.ranges`` does, ``{"input": ..., "act_i": ...}`` of ``{"min",
"max"}`` as float32.  Like the reference, a rule imports nothing of the
program."""
