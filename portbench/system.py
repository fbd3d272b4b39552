"""The system under test, reached through its public entry points only:
``models/cfg.py::parse_cfg`` reads the config's ``.cfg`` text,
``infer/convert.py::convert`` turns the benchmark's float weights and
ranges into the integer program, and ``infer/engine.py::Engine`` serves it;
the window drives ``Engine.predict_async`` and its resolver.  A
configuration's ``"convert"`` and ``"engine"`` objects reach those two as
keyword options, as given.

This is the one module of the benchmark that imports the program.
"""

from __future__ import annotations

# weight scheme -> convert's symmetric_weights; the default reference
# converts the symmetric one only, so a configuration with the other names
# a reference of its own
WEIGHT_SCHEMES = {"symmetric_per_channel_int8": True, "asymmetric_per_channel_uint8": False}
# options the configuration sets by its own keys, or the harness by the run
SET_ELSEWHERE = {"convert": {"symmetric_weights": "the key 'weights'"},
                 "engine": {"max_det": "the key 'max_det'", "device": "the run"}}


def options(config: dict) -> tuple[dict, dict]:
    """(convert's keyword options, Engine's) of a configuration; a
    ValueError where its weight scheme is unknown, or where ``convert`` or
    ``engine`` is not an object or names an option set elsewhere."""
    if config["weights"] not in WEIGHT_SCHEMES:
        raise ValueError(f"weights {config['weights']!r} is none of {sorted(WEIGHT_SCHEMES)}")
    given = {}
    for entry, elsewhere in SET_ELSEWHERE.items():
        given[entry] = config.get(entry, {})
        if not isinstance(given[entry], dict):
            raise ValueError(f"{entry!r} is not an object of options")
        clash = sorted(given[entry].keys() & elsewhere.keys())
        if clash:
            raise ValueError(f"{entry!r} names {clash[0]!r}, which {elsewhere[clash[0]]} sets")
    return ({**given["convert"], "symmetric_weights": WEIGHT_SCHEMES[config["weights"]]},
            dict(given["engine"]))


def engine(config: dict, cfg_text: str, params: dict, ranges: dict, device):
    """The program's Engine for one configuration, built from the inputs the
    benchmark made."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.cfg import parse_cfg

    convert_options, engine_options = options(config)
    net, _ = parse_cfg(cfg_text)
    program = convert(net, params, ranges, **convert_options)
    return Engine(program, max_det=config["max_det"], device=device, **engine_options)
