"""The system under test, reached through its public entry points only:
``models/cfg.py::parse_cfg`` reads the config's ``.cfg`` text,
``infer/convert.py::convert`` turns the benchmark's float weights and
ranges into the integer program, and ``infer/engine.py::Engine`` serves it;
the window drives ``Engine.predict_async`` and its resolver.

This is the one module of the benchmark that imports the program.
"""

from __future__ import annotations

WEIGHT_SCHEMES = {"symmetric_per_channel_int8": True}


def engine(config: dict, cfg_text: str, params: dict, ranges: dict, device):
    """The program's Engine for one configuration, built from the inputs the
    benchmark made."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.cfg import parse_cfg

    net, _ = parse_cfg(cfg_text)
    program = convert(net, params, ranges,
                      symmetric_weights=WEIGHT_SCHEMES[config["weights"]])
    return Engine(program, max_det=config["max_det"], device=device)
