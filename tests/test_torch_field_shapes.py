"""The shapes the forward kernels' tile body takes, held on the CPU.

K1 and K3 raise in their wrappers, before a launch, on what their tile body
(``csrc/field_fwd.cuh``) cannot take: rays of S samples where S neither
divides 64 nor is a multiple of 64 up to ``MAX_SAMPLES``, rays split across
CTAs, and hidden widths that are not whole 64-column blocks in one pass of
at most ``PASS_COLS`` columns, or in two passes of half the width.
``stream_slices`` sizes the weight stream the kernels pack per call.
"""

import pytest

from gazenerf_tpu_torch.kernels import fused_field as ff
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("hidden, ok", [(64, True), (128, True), (192, True), (256, True),
                                        (384, True), (96, False), (320, False), (448, False)])
def test_hidden_widths_the_tile_takes(hidden, ok):
    """64-column blocks in one pass up to 192 columns, or two passes of half
    the width up to 384; anything else raises before a launch."""
    assert ff.takes_hidden(hidden) == ok
    if ok:
        ff.check_shapes(16, 8, hidden, hidden // 2, 64, 63)
    else:
        with pytest.raises(ValueError, match="hidden width"):
            ff.check_shapes(16, 8, hidden, hidden // 2, 64, 63)


@pytest.mark.parametrize("R, S", [(16, 7), (6, 32), (3, 64), (16, 96), (16, 320), (3, 192)])
def test_rays_the_tile_cannot_take_raise(R, S):
    """Whole rays in every CTA: S divides 64 or is a multiple of 64 up to
    MAX_SAMPLES, and R is a multiple of the CTA's rays (TILE_POINTS / S, or
    2 at S = 192)."""
    with pytest.raises(ValueError, match="whole rays"):
        ff.check_shapes(R, S, 64, 32, 64, 63)


def test_embedding_width_in_whole_blocks():
    """The padded embedding is one or more 64-column blocks, at least De."""
    ff.check_shapes(16, 8, 64, 32, 64, 63)
    for Kp in (48, 32):
        with pytest.raises(ValueError, match="padded embedding width"):
            ff.check_shapes(16, 8, 64, 32, Kp, 31)


@pytest.mark.parametrize("H, Kp, slices", [(64, 64, 22), (128, 64, 40), (384, 64, 212)])
def test_stream_slices(H, Kp, slices):
    """Per trunk pass fea_0's Kp / 32 slices, six hidden layers' and rgb_0's
    H / 32 each and fea_5's (Kp + H) / 32, then rgb_1's H / 32 (hidden 384:
    two passes a layer, 212 slices of 12 KB, the 2.6 MB of weights)."""
    assert ff.stream_slices(H, Kp) == slices
