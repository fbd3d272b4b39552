"""The arithmetic of the per-layer metrics on hand-counted work."""

import pytest

from portbench import yardstick
from portbench.reference import darknet_cfg
from portbench import harness

CONV = ("[net]\nwidth=8\nheight=8\nchannels=8\n"
        "[convolutional]\nbatch_normalize=1\nfilters=16\nsize=3\npad=1\nactivation=leaky\nquantized=1\n")
POOL = "[maxpool]\nsize=2\nstride=2\nquantized=1\n"
SHORTCUT = ("[convolutional]\nbatch_normalize=1\nfilters=16\nsize=1\npad=1\nactivation=leaky\n"
            "quantized=1\n[shortcut]\nfrom=-2\nactivation=linear\n")


def test_one_conv():
    net = darknet_cfg.parse(CONV)
    assert yardstick.conv_macs_per_image(net) == 8 * 8 * 16 * 9 * 8
    # batch 2: codes in 2*8*8*8 and out 2*8*8*16, weights 9*8*16, bias and m 8*16
    nbytes, ops = yardstick.conv_work(net, 2)[0]
    assert nbytes == 1024 + 2048 + 1152 + 128
    assert ops == 2 * 73728 * 2
    assert yardstick.conv_least_s(net, 2) == pytest.approx(4352 / 3.35e12)


def test_a_pool_after_the_conv_counts_its_output():
    net = darknet_cfg.parse(CONV + POOL)
    assert yardstick.conv_work(net, 2)[0][0] == 1024 + 2 * 4 * 4 * 16 + 1152 + 128
    # a route reading the conv keeps its whole output
    net = darknet_cfg.parse(CONV + POOL + "[route]\nlayers=-2\n")
    assert yardstick.conv_work(net, 2)[0][0] == 4352


def test_shortcut_and_an_operation_bound_conv():
    net = darknet_cfg.parse(CONV + SHORTCUT)
    assert yardstick.shortcut_least_s(net, 4) == pytest.approx(3 * 4 * 8 * 8 * 16 / 3.35e12)
    big = darknet_cfg.parse("[net]\nwidth=64\nheight=64\nchannels=512\n[convolutional]\n"
                            "filters=512\nsize=3\npad=1\nactivation=leaky\nquantized=1\n")
    nbytes, ops = yardstick.conv_work(big, 64)[0]
    assert ops / 1979e12 > nbytes / 3.35e12
    assert yardstick.conv_least_s(big, 64) == pytest.approx(ops / 1979e12)


@pytest.mark.parametrize("cell,gmac", [("tiny416-b128-closed", 2.724), ("v3-416-b64-offline", 32.93)])
def test_macs_of_the_configs(root, cell, gmac):
    """As ``tools/bench.py`` counts them."""
    _, config = harness.cell_files(root, cell)
    net = darknet_cfg.parse(harness.cfg_text(config, 416))
    assert yardstick.conv_macs_per_image(net) / 1e9 == pytest.approx(gmac, abs=5e-3)


def test_readers_on_a_summary(root):
    _, config = harness.cell_files(root, "v3-416-b64-offline")
    net = darknet_cfg.parse(harness.cfg_text(config, 416))
    conv_s = yardstick.conv_least_s(net, 64)
    sc_s = yardstick.shortcut_least_s(net, 64)
    ops = [["void qconv_wgmma_kernel<1>(Params)", 4 * conv_s, 10],
           ["(anonymous namespace)::shortcut_kernel(uint4)", 2 * sc_s, 46],
           ["at::native::vectorized_elementwise_kernel<add>", 0.001, 99]]
    summary = {"net": net, "batch": 64,
               "window": {"seconds": 10.0, "images": 32000, "dispatch_s": [0.003, 0.004, 0.005]},
               "trace": {"window_s": 0.5, "busy_s": 0.4, "device_ops": ops, "forwards": 2,
                         "images": 128}}
    read = {name: harness.reader(name)(summary) for name in
            ("qconv_roofline.offline", "shortcut_roofline.offline", "glue_device_us_per_image.offline",
             "device_idle_share.offline", "mfu_int8.offline", "dispatch_ms.closed")}
    assert read["qconv_roofline.offline"] == pytest.approx(50.0)
    assert read["shortcut_roofline.offline"] == pytest.approx(100.0)
    assert read["glue_device_us_per_image.offline"] == pytest.approx(0.001 / 128 * 1e6)
    assert read["device_idle_share.offline"] == pytest.approx(20.0)
    assert read["mfu_int8.offline"] == pytest.approx(2 * 32.93e9 * 3200 / 1979e12 * 100, rel=1e-3)
    assert read["dispatch_ms.closed"] == pytest.approx(4.0)
    summary["trace"]["device_ops"] = []
    assert harness.reader("shortcut_roofline.offline")(summary) is None
    assert harness.reader("qconv_roofline.closed")(summary) is None
