"""Semantic segmentation training and prediction (darknet's segmenter).

The counterpart of ``yolo_quantization_tpu/train/segment.py``
(examples/segmenter.c train_segmenter / predict_segmenter): a
``NetworkDef`` whose last layer gives per-pixel class maps, trained with
per-pixel softmax cross entropy against mask images.  Masks follow
darknet's convention: the image path with "images" replaced by "mask", a
PNG whose value is the class index.  The trainer runs on the GPU unless
given ``device="cpu"``; with a device ``mesh`` it is data-parallel through
``parallel/mesh.py::data_parallel``, as the detector's ``Trainer``.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_quantization_tpu_torch.data.image import load_image_rgb, resize_bilinear_darknet
from yolo_quantization_tpu_torch.data.voc import read_image_list
from yolo_quantization_tpu_torch.infer.float_engine import resolve_device
from yolo_quantization_tpu_torch.nn.graph import ForwardMode, NetworkDef
from yolo_quantization_tpu_torch.parallel import mesh as pmesh
from yolo_quantization_tpu_torch.train.classify import _forward_all, _sgd_state, cross_entropy
from yolo_quantization_tpu_torch.train.qat import roll_bn_stats, to_device


def mask_path_for(image_path: str) -> str:
    return image_path.replace("images", "mask").rsplit(".", 1)[0] + ".png"


class SegmentationDataset:
    def __init__(self, list_file: str, net_w: int, net_h: int, classes: int):
        self.paths = read_image_list(list_file)
        self.net_w, self.net_h = net_w, net_h
        self.classes = classes

    def __len__(self):
        return len(self.paths)

    def sample(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        p = self.paths[idx % len(self.paths)]
        im = resize_bilinear_darknet(load_image_rgb(p), self.net_w, self.net_h)
        with Image.open(mask_path_for(p)) as m:
            mask = np.asarray(m.convert("L").resize((self.net_w, self.net_h), Image.NEAREST), dtype=np.int32)
        return im, np.clip(mask, 0, self.classes - 1)


class SegmenterTrainer:
    """Per-pixel softmax cross entropy on the net's last feature map (the
    mask taken at the map's resolution, nearest), SGD with momentum, BN
    rolling statistics at .99/.01.  ``step`` takes (images (N, H, W, 3),
    masks (N, H, W) of class indices): with a ``mesh``, this rank's rows of
    the global batch."""

    def __init__(self, net: NetworkDef, classes: int, lr: float = 1e-3, momentum: float = 0.9,
                 seed: int = 0, device=None, mesh=None, fsdp: bool = False):
        self.net = net
        self.classes = classes
        self.device = resolve_device(device, "SegmenterTrainer")
        self.state, self.group = pmesh.data_parallel(
            _sgd_state(net, seed, self.device, lr, momentum, 0.0), mesh, fsdp)
        self.mode = ForwardMode(train=True, group=self.group)

    @property
    def params(self):
        return self.state.params

    def step(self, images, masks) -> dict:
        x = to_device(images, self.device)
        masks = to_device(masks, self.device, torch.int64)
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        outs, bn_stats = _forward_all(self.net, self.state, x, self.mode)
        logits = outs[-1]  # (N, h, w, classes)
        fh, fw = logits.shape[1:3]
        ys = torch.arange(fh, device=self.device) * masks.shape[1] // fh
        xs = torch.arange(fw, device=self.device) * masks.shape[2] // fw
        loss = torch.mean(cross_entropy(logits, masks[:, ys][:, :, xs]))
        loss.backward()
        opt.step()
        roll_bn_stats(self.state.params, bn_stats)
        n = x.shape[0] * pmesh.rank_world(self.group)[1]
        self.state = self.state._replace(step=self.state.step + 1, seen=self.state.seen + n)
        return {"loss": pmesh.global_mean(loss.detach(), self.group)}

    @torch.no_grad()
    def predict(self, image: np.ndarray) -> np.ndarray:
        """Per-pixel argmax class map at the feature resolution, resized
        back to the image's size (nearest; predict_segmenter)."""
        from PIL import Image

        outs, _ = _forward_all(self.net, self.state._replace(model=None),
                               to_device(image[None], self.device), ForwardMode())
        pred = torch.argmax(outs[-1][0], dim=-1).to(torch.uint8).cpu().numpy()
        return np.asarray(Image.fromarray(pred).resize((image.shape[1], image.shape[0]), Image.NEAREST))
