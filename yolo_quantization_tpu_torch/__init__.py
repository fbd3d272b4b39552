"""yolo_quantization_tpu_torch — the PyTorch/CUDA port of yolo_quantization_tpu.

The JAX package ``yolo_quantization_tpu`` is the reference; this package
mirrors its module paths and names so each counterpart sits at the same
relative path, and it never imports ``jax``.  Layouts at every public
function are the reference's: NHWC activations, HWIO weights, and the same
``.npz`` array names.

Its modules (training, darknet I/O and the other model families beside
these are in models/, train/ and nn/):

  nn/graph.py        model description (specs, NetworkDef, numpy init)
  core/quant.py      host-side quant math (multiplier encoding)
  models/            yolov3-tiny builder, flagship and C-parity presets
  infer/convert.py   float params + ranges -> IntProgram (numpy)
  infer/serialize.py yoloq-intprogram-v1 .npz save/load
  ops/qconv.py       plain PyTorch integer conv and s2d stem (the oracles)
  ops/cuda_qconv.py  hand-written CUDA int8 conv kernel wrapper (csrc/qconv.cu)
  ops/cuda_s2d.py    hand-written CUDA s2d stem kernel wrapper (csrc/s2d_qconv.cu)
  nn/layers.py       integer maxpool / nearest upsample
  infer/engine.py    IntProgram -> forward on a torch device, decode, top-k,
                     flip TTA, per-resolution engines
  eval/detect.py     yolo decode, flip averaging, top-k, box correction, NMS
  eval/f1.py         darknet's F1 and recall counting
  data/image.py      image decoding, darknet letterbox
  data/voc.py        image lists and label files
  infer/serving.py   continuous-batching Server
  eval/valid.py      VOC/COCO/ImageNet result writers and VOC mAP
  utils/native.py    ctypes binding of the native host runtime (native/*.cc)
  utils/profiling.py the one profiler-range helper (span), torch.profiler
                     trace, step timer, JSONL metrics
  data/video.py      OpenCV video read/write
  cli/               the command line (python -m yolo_quantization_tpu_torch.cli)
  parity/ctwin.py    numpy twin of the darknet C binary's uint8 arithmetic
  tools/             the GEMM-orientation probe (csrc/gemm_probe.cu), the
                     forward's profiler breakdown, the C-parity harness
                     (parity_check, crossf1), the benchmarks (bench,
                     bench_serving, bench_train) and the dry run (dryrun)
"""

__version__ = "0.1.0"
