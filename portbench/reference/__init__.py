"""The plain reference: imports nothing of the program.

``darknet_cfg`` and ``model`` are the default.  A configuration whose
mathematics they do not read names a module of its own here,
``"reference": "<module>"``, which the harness loads by its path and which
exposes ``parse(text)`` (a ``darknet_cfg.Network`` of ``darknet_cfg.Layer``),
``convert(net, params, ranges, device, bits=8)`` (a ``model.Program``),
``heads(program, frames)``, ``candidates(program, frames, max_det, tie,
block=16)`` and ``answers(program, frames, max_det, block=16)``, each as
``model``'s does, and may expose ``answer_count(net, max_det)``.  It may
import ``darknet_cfg`` and ``model`` and reuse their functions, and never
rebinds a name of theirs."""
