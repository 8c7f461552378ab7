"""The port's kernel modules on the CPU, against their JAX counterparts.

The stage-major schedule's emulation at AlexNet's chain
(conv3 -> conv4 -> conv5 + pool5), batch 1 and 2.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

from repro_torch.kernels.conv2d import ops as conv_ops
from torch_kernels_common import POOL32, TOL, _arr, _close, _emulate_chain, _t


@pytest.mark.parametrize("n", [1, 2])
def test_chain_schedule_at_alexnet_matches_the_plain_chain(n):
    """The emulated schedule at AlexNet's chain (one chunk an item at
    these batches: taps cut in two or three), and K6's at
    ``oc_block_final`` 100 (128-wide final items), equal
    ``conv2d_chain_ref``."""
    rng = np.random.default_rng(n)
    x = _t(_arr(rng, n, 256, 13, 13))
    ws, bs, c = [], [], 256
    for oc in (384, 384, 256):
        ws.append(_t(_arr(rng, oc, c, 3, 3, scale=(9 * c) ** -0.5)))
        bs.append(_t(_arr(rng, oc, scale=0.05)))
        c = oc
    args = ([(1, 1)] * 3, [(1, 1)] * 3, [True] * 3)
    ref = conv_ops.conv2d_chain_ref(x, ws, bs, *args, pool_kernel=(3, 3),
                                    pool_stride=(2, 2))
    for ocb in (None, conv_ops.k6_ocb(100)):
        ours = _emulate_chain(x, ws, bs, *args, POOL32, None, ocb)
        _close(ours, ref.numpy(), TOL * max(1.0, ref.abs().max().item()))
