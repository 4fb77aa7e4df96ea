"""PyTorch port: ``TrainConfig.matmul_precision``, scoped to the train and
eval steps as the JAX package's ``_with_precision`` scopes its jitted steps.

The JAX package on the CPU ignores the setting (a 64×64 f32 product has the
same error against float64 under every name), so no CPU test can hold the
reduced precisions against it; these tests hold the port to the meaning of
each name instead: ``"highest"`` bit-equal to the default (f32 on the CPU);
``"bfloat16"`` against a numpy product of the bf16-rounded operands in
float64, within 1e-5 of its largest magnitude (the f32 sum's order), and at
least 1e-3 of it from the f32 product, forward and backward GEMMs alike;
``"tensorfloat32"`` equal to f32 on the CPU, as torch computes it there. The
process's setting is restored after every step, so an ``Inferencer``, an
``Evaluator`` or another trainer in the same process is untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.train.precision import Bf16Operands, matmul_precision
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from helpers import random_graph

torch.set_num_threads(1)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def _held(got, want, f32):
    got, top = np.asarray(got, np.float64), float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * top
    assert np.abs(got - f32).max() >= 1e-3 * top


def test_jax_cpu_ignores_the_setting(rng):
    """Fact: every name gives the JAX package one f32 product on the CPU."""
    a, b = (rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2))
    outs = []
    for prec in ("highest", "tensorfloat32", "bfloat16"):
        with jax.default_matmul_precision(prec):
            outs.append(np.asarray(jax.jit(jnp.matmul)(a, b)))
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "einsum", "linear", "matmul"])
def test_bfloat16_gemms_take_rounded_operands(rng, op):
    a = rng.standard_normal((3, 48, 64)).astype(np.float32)
    b = rng.standard_normal((3, 64, 40)).astype(np.float32)
    c = rng.standard_normal((40,)).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    run = {"mm": lambda: ta[0] @ tb[0], "addmm": lambda: torch.addmm(tc, ta[0], tb[0]),
           "bmm": lambda: torch.bmm(ta, tb), "einsum": lambda: torch.einsum("bij,bjk->bik", ta, tb),
           "linear": lambda: torch.nn.functional.linear(ta[0], tb[0].T, tc),
           "matmul": lambda: torch.matmul(ta, tb)}[op]
    with matmul_precision("bfloat16"):
        got = run().numpy()
    f32 = run().numpy()
    ab = _bf16(a) @ _bf16(b)
    want = {"mm": ab[0], "addmm": ab[0] + c, "bmm": ab, "einsum": ab, "linear": ab[0] + c,
            "matmul": ab}[op]
    _held(got, want, f32)


def test_bfloat16_backward_gemms_take_rounded_operands(rng):
    x = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32)).requires_grad_()
    lin = torch.nn.Linear(48, 24)
    g = rng.standard_normal((32, 24)).astype(np.float32)
    with matmul_precision("bfloat16"):
        (lin(x) * torch.from_numpy(g)).sum().backward()
    w = lin.weight.detach().numpy()
    _held(x.grad.numpy(), _bf16(g) @ _bf16(w), g @ w)
    _held(lin.weight.grad.numpy(), _bf16(g).T @ _bf16(x.detach().numpy()),
          g.T @ x.detach().numpy())


@pytest.mark.parametrize("prec", [None, "highest", "tensorfloat32", "bfloat16"])
def test_steps_scope_the_setting_and_restore_it(rng, prec, monkeypatch):
    """A train and an eval step under each name: inside, the GEMMs run at
    that setting (the bf16 mode is active exactly under "bfloat16"); after
    each, the process's setting (here "high", not the default) is back.
    "highest" is bit-equal to the default, "tensorfloat32" too on the CPU,
    "bfloat16" is not."""
    jt = random_graph(np.random.default_rng(1), n=20, extra_edges=10)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    xb = rng.standard_normal((2, 20)).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[::3] = True
    seen = []
    real = Bf16Operands.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        seen.append(func)
        return real(self, func, types, args, kwargs)

    monkeypatch.setattr(Bf16Operands, "__torch_dispatch__", spy)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        results = {}
        for p in (None, prec):
            model = GATRes(2, 8, attn_impl="factored")
            model.reset_parameters(torch.Generator().manual_seed(3))
            tr = Trainer(model, TrainConfig(batch_size=2, mask_rate=0.5, matmul_precision=p),
                         NormStats(), tpl, device="cpu")
            loss, _ = tr.train_step(tpl, xb, mask)
            assert torch.get_float32_matmul_precision() == "high"
            vloss, _, _, _ = tr.eval_step(tpl, xb, mask)
            assert torch.get_float32_matmul_precision() == "high"
            results[p] = (loss, vloss, [q.detach().clone() for q in model.parameters()])
    finally:
        torch.set_float32_matmul_precision(before)
    assert bool(seen) == (prec == "bfloat16")
    same = all(torch.equal(a, b) for a, b in zip(results[None][2], results[prec][2]))
    assert same == (prec != "bfloat16")
    assert torch.equal(results[None][1], results[prec][1]) == (prec != "bfloat16")


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="matmul_precision"):
        with matmul_precision("float16"):
            pass
