"""Float and fake-quant simulation engines with the integer Engine's API.

The counterpart of ``yolo_quantization_tpu/infer/float_engine.py``:

  - ``FloatEngine`` runs the graph in float (BN rolling stats, no
    fake-quant): float checkpoints and the float accuracy reference;
  - ``QatSimEngine`` runs the graph QAT optimized (fake-quant with the
    trained ranges): the faithfulness reference for the integer engine.

Both run on the GPU unless ``device`` says otherwise (``"cpu"``), and raise
where there is no GPU and no device was given.  ``predict`` decodes and
top-k's on the device; ``predict_async``, ``raw_heads``, flip TTA and
``at_size`` are as in the integer engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.nn.graph import (
    HEAD_SPECS,
    ForwardMode,
    NetworkDef,
    YoloSpec,
    forward,
    params_to_torch,
    quant_state_to_torch,
)


def resolve_device(device, who: str) -> torch.device:
    """``device``, or the GPU when it is None; a GPU where there is none
    raises: never a silent CPU fallback."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the GPU unless asked otherwise, and "
            "torch.cuda.is_available() is false; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def _as_device_tensors(tree, device, to_torch):
    """numpy trees go through ``to_torch``; tensor trees are detached copies
    on ``device`` (the engine never aliases a trainer's live tensors)."""
    first = next(iter(next(iter(tree.values())).values()))
    if isinstance(first, torch.Tensor):
        return {k: {n: v.detach().to(device, copy=True) for n, v in d.items()} for k, d in tree.items()}
    return to_torch(tree, device)


class FloatEngine:
    _mode = ForwardMode()

    def __init__(self, net: NetworkDef, params, max_det: int = 256, device=None,
                 _device_params=None, _quant_state=None):
        self.device = resolve_device(device, type(self).__name__)
        self.net = net
        self.max_det = max_det
        self.params = (_device_params if _device_params is not None
                       else _as_device_tensors(params, self.device, params_to_torch))
        self.quant_state = _quant_state
        self._head_specs = [s for s in net.specs if isinstance(s, HEAD_SPECS)]
        # on the device before the first request, so the enqueue never waits
        self._anchors = detect.head_anchors(net, self.device)
        self._size_cache: dict[tuple[int, int], FloatEngine] = {}

    @property
    def program(self):  # duck-type Engine for the eval harnesses
        class _P:
            net = self.net

        return _P()

    def _heads(self, x: torch.Tensor) -> list[torch.Tensor]:
        return forward(self.net, self.params, x, self._mode, self.quant_state)[0]

    def _same_engine(self, net: NetworkDef):
        return FloatEngine(net, None, max_det=self.max_det, device=self.device,
                           _device_params=self.params)

    def at_size(self, height: int, width: int | None = None):
        """The engine for another input resolution, cached per size and
        sharing this engine's device tensors; the native size is ``self``."""
        width = width or height
        if (height, width) == (self.net.height, self.net.width):
            return self
        if height % 32 or width % 32:
            raise ValueError(f"input size must be a multiple of 32, got {height}x{width}")
        eng = self._size_cache.get((height, width))
        if eng is None:
            eng = self._same_engine(dataclasses.replace(self.net, height=height, width=width))
            self._size_cache[(height, width)] = eng
        return eng

    def _input(self, images) -> torch.Tensor:
        """numpy images, or a tensor on any device (moved to the engine's)."""
        net = self.net
        if tuple(images.shape[1:]) != (net.height, net.width, net.channels):
            raise ValueError(f"engine expects {(net.height, net.width, net.channels)} images, "
                             f"got {tuple(images.shape[1:])}")
        if isinstance(images, torch.Tensor):
            return images.to(self.device, torch.float32).contiguous()
        return torch.as_tensor(np.ascontiguousarray(images, np.float32), device=self.device)

    def predict(self, images: np.ndarray, flip: bool = False):
        """Decoded (boxes, obj, cls) top-k as numpy; ``flip`` averages the
        yolo heads over the horizontal mirror."""
        return self.predict_async(images, flip=flip)()

    def predict_async(self, images: np.ndarray, flip: bool = False):
        """Enqueue a batch on the current stream and return a zero-arg
        resolver that copies (boxes, obj, cls) to the host."""
        with torch.inference_mode():
            x = self._input(images)
            if flip:
                n = x.shape[0]
                heads = self._heads(torch.cat([x, x.flip(2)]))
                heads = [detect.flip_average_head(h[:n], h[n:], spec.classes)
                         if isinstance(spec, YoloSpec) else h[:n]
                         for h, spec in zip(heads, self._head_specs)]
            else:
                heads = self._heads(x)
            boxes, obj, cls = detect.decode_all_heads(heads, self.net, self._anchors)
            out = detect.top_k_detections(boxes, obj, cls, self.max_det)
        return lambda: tuple(t.cpu().numpy() for t in out)

    def raw_heads(self, images: np.ndarray):
        with torch.inference_mode():
            return [h.cpu().numpy() for h in self._heads(self._input(images))]


class QatSimEngine(FloatEngine):
    """The fake-quant simulation forward (``ForwardMode(qat=True)`` with the
    trained ranges) with the Engine API."""

    _mode = ForwardMode(train=False, qat=True)

    def __init__(self, net: NetworkDef, params, quant_state, max_det: int = 256, device=None,
                 _device_params=None, _quant_state=None):
        super().__init__(net, params, max_det=max_det, device=device, _device_params=_device_params)
        self.quant_state = (_quant_state if _quant_state is not None
                            else _as_device_tensors(quant_state, self.device, quant_state_to_torch))

    def _same_engine(self, net: NetworkDef):
        return QatSimEngine(net, None, None, max_det=self.max_det, device=self.device,
                            _device_params=self.params, _quant_state=self.quant_state)
