"""Cross-binary parity tooling against the compiled reference darknet.

The counterpart of ``yolo_quantization_tpu/parity``.  ``ctwin`` is a numpy
transcription of the reference's integer inference pipeline, bit-exact to
the compiled C binary; ``tools/parity_check.py`` scores the port's engine
against it and ``tools/crossf1.py`` counts F1 with it.
"""
