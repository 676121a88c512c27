"""The sharded Mamba2 train step in float64 against the one-device step in
float64: whether the sharded step's float32 gradients part from a float64
step by more than the one-device step's because of summation order or
because of a fault in the partitioned step.

The shapes are those at which ``chip_smoke.py`` phase 14(d) found the
float32 sharded step 2-3 times farther from a float64 one-device step
than the float32 one-device step (``conv_bc`` and ``zx_proj``): reduced
mamba2-780m on 12 layers, 2 x 2,048 tokens under remat (256 SSD chunks
of 8 a row), and reduced zamba2-7b on 12 layers (the shared attention
block after every second), 4 x 1,024 tokens in 2 microbatches
accumulated in float64, on a 2 x 2 grid of the CPU device.

A float64 configuration is not float64 throughout: the norms, the
gated norm, the convolutions' SiLU, the SSD state carry and the loss's
softmax cast to float32 (``Tensor.float``), as the float32 model does.
The sharded step sums some of those float32 islands in another order
(the gated norm's sum of squares over ``"model"``, the vocab-parallel
log-sum-exp), so with the islands in place the two float64 steps part at
float32 rounding, about a tenth of the float32 steps' distance.  With
the islands lifted (``Tensor.float`` keeps a float64 tensor float64)
both steps compute every sum in float64, and the gathered gradients
agree to the sharded step's final rounding to float32 gradients (6e-8
relative, 6e-4 of the bound): the test holds every leaf within 1/100 of
phase 12(a)'s bound (``rtol`` 1e-4, ``atol`` 1e-6), at least 100 times
below the float32 one-device step's distance at these shapes (1.5-3.5
times the bound).  A fault in the partitioned step (a wrong group of B
and C, a missing or doubled sum) moves a gradient by far more.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.layers import float64_throughout
from repro_torch.sharding.placement import gather
from repro_torch.train import make_optimizer
from repro_torch.train.train_step import grads_and_metrics
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

from test_torch_sharded_step import grid, place

#: the bound of chip_smoke.py phase 12(a), and the share of it the float64
#: steps must agree within
GRAD_RTOL, GRAD_ATOL, SHARE = 1e-4, 1e-6, 1e-2
#: name -> (arch, layers, rows, tokens a row, overrides)
CASES = {
    "mamba2-12-layers": ("mamba2-780m", 12, 2, 2048, {"remat": True}),
    "zamba2-4x1024": ("zamba2-7b", 12, 4, 1024, {"grad_accum": 2}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's other workers load the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` over ``atol + rtol·|want|``."""
    d = (got.double() - want.double()).abs()
    return float((d / (GRAD_ATOL + GRAD_RTOL * want.double().abs())).max())


@pytest.mark.parametrize("name", list(CASES))
def test_float64_sharded_gradients_match_the_one_device_step(name):
    arch, layers, rows, seq, over = CASES[name]
    cfg = get_config(arch, reduced=True, **over).with_(
        n_layers=layers, param_dtype="float64", activ_dtype="float64",
        grad_accum_dtype="float64")
    params = tree_map(lambda x: x.double(),
                      T.init_model(cfg, torch.Generator().manual_seed(0)))
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab, (rows, seq + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    mesh = grid((2, 2))
    placed, _ = place(cfg, params, make_optimizer(cfg.optimizer).init(params),
                      mesh, cfg.optimizer)
    with float64_throughout():
        want, m1 = grads_and_metrics(cfg, params, batch)
        got, m2 = grads_and_metrics(cfg, placed, batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-12)
    worst = max(((ratio(gather(g), w), "/".join(map(str, path)))
                 for (path, w), g in zip(tree_flatten_with_path(want),
                                         tree_leaves(got))))
    assert worst[0] <= SHARE, worst
