"""The QAT forward and backward of the narrow darknet53-shaped net of
``test_torch_v3.py`` (64x64: stride-2 convs, shortcuts with their own
ranges, routes, upsamples, three heads) against the JAX package's, layer by
layer in every mode and whole in the float-train mode, by the rules of
``test_torch_qat.py`` (split from it so each file stays under 40 s on one
worker)."""

import pytest
import torch

from test_torch_qat import MODES, calibrate, check_every_layer, check_whole_float_train

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def narrow():
    return calibrate("narrow_v3")


@pytest.mark.parametrize("mode_name", MODES)
def test_every_layer_matches_jax(narrow, mode_name):
    check_every_layer(*narrow, mode_name)


def test_whole_float_train_forward_matches_jax():
    check_whole_float_train("narrow_v3")
