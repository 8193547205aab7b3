"""The mixture-of-experts FFN (``ops/moe.py``) and the MoE transformer on
one process, against the reference (≙ ``tests/test_moe.py``'s dense
cases): the same numpy inputs from a seed through the reference's
``moe_ffn`` (under ``jax.grad``) and the port's (under autograd).

* ``moe_ffn``: output, aux and the gradients of every input for
  ``Σ out·ct + c·aux``, top-1 and top-2, loose and binding capacity, in
  float32 (``rtol 1e-5, atol 1e-6``: the reference test's tolerance
  for two routings of the same groups) and bfloat16 (within 2 bf16
  ulps of the output's scale: both sides round the products to bf16
  at the same points, in other orders).
* The reference test's oracles: the per-token loop, capacity overflow,
  top-2 against the two-expert loop and overflow to the second choice
  (``test_moe.py:34,51,342,395``).
* The two rules the reference gets from JAX: a slot past capacity is an
  all-zero one-hot row, and a tie routes to the first expert.
* The MoE transformer's forward and aux, and one training gradient,
  against the reference's, with and without remat (``full`` and
  ``save_attn``), and the group-count refusals with the reference's
  messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.models import transformer as ref_transformer
from distributedmnist_tpu.ops.moe import moe_ffn as ref_moe_ffn
from distributedmnist_tpu_torch.models import transformer
from distributedmnist_tpu_torch.models.convert import params_from_reference
from distributedmnist_tpu_torch.ops import moe

E, D, FF = 4, 8, 16
TOL_F32 = dict(rtol=1e-5, atol=1e-6)
BF16_ULPS = 2.0


def _inputs(seed: int, b: int = 2, s: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(b, s, D)).astype(np.float32),
            "router": (rng.normal(size=(D, E)) * 0.5).astype(np.float32),
            "w1": (rng.normal(size=(E, D, FF)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(E, FF, D)) * 0.1).astype(np.float32),
            "ct": rng.normal(size=(b, s, D)).astype(np.float32)}


NAMES = ("x", "router", "w1", "w2")


def _ref(p, dtype, **kw):
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731

    def objective(x, router, w1, w2):
        out, aux = ref_moe_ffn(x, router, w1, w2, num_experts=E, **kw)
        return (jnp.sum(out.astype(jnp.float32) * p["ct"]) + 0.7 * aux,
                (out, aux))

    (_, (out, aux)), grads = jax.value_and_grad(
        objective, argnums=(0, 1, 2, 3), has_aux=True)(
            *(cast(p[n]) for n in NAMES))
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(p, dtype, **kw):
    ts = [torch.tensor(p[n]).to(dtype).requires_grad_(True) for n in NAMES]
    out, aux = moe.moe_ffn(*ts, num_experts=E, **kw)
    ((out.float() * torch.tensor(p["ct"])).sum() + 0.7 * aux).backward()
    assert out.dtype == dtype and aux.dtype == torch.float32
    return (out.detach().float().numpy(), float(aux.detach()),
            [t.grad.float().numpy() for t in ts])


CASES = [(1, 4.0, 0), (1, 1.0, 2), (2, 2.0, 0), (2, 1.0, 4)]


@pytest.mark.parametrize("top_k,cf,groups", CASES)
def test_moe_ffn_float32_matches_the_reference(top_k, cf, groups):
    p = _inputs(top_k * 10 + groups)
    kw = dict(capacity_factor=cf, router_top_k=top_k, num_groups=groups)
    want = _ref(p, jnp.float32, **kw)
    got = _port(p, torch.float32, **kw)
    np.testing.assert_allclose(got[0], want[0], **TOL_F32)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for name, g, w in zip(NAMES, got[2], want[2]):
        np.testing.assert_allclose(g, w, **TOL_F32, err_msg=name)


@pytest.mark.parametrize("top_k,cf,groups", CASES)
def test_moe_ffn_bfloat16_matches_the_reference(top_k, cf, groups):
    """In bfloat16 (routing in float32 from bf16 logits, the FFN in
    bf16) each output and gradient is within ``BF16_ULPS`` bf16 ulps of
    its own largest entry of the reference's; the aux to 1e-6."""
    p = _inputs(100 + top_k * 10 + groups)
    kw = dict(capacity_factor=cf, router_top_k=top_k, num_groups=groups)
    want = _ref(p, jnp.bfloat16, **kw)
    got = _port(p, torch.bfloat16, **kw)
    ulp = 2.0 ** -8
    for name, g, w in zip(("out",) + NAMES, (got[0], *got[2]),
                          (want[0], *want[2])):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= BF16_ULPS * ulp * scale, name
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_capacity_binds_in_the_cases():
    """The binding cases drop slots: their outputs differ from the same
    inputs at a capacity every token fits in."""
    for top_k, cf, groups in CASES:
        if cf * top_k >= E:
            continue
        p = _inputs(top_k * 10 + groups)
        outs = [_port(p, torch.float32, capacity_factor=c,
                      router_top_k=top_k, num_groups=groups)[0]
                for c in (cf, float(E))]
        assert np.abs(outs[0] - outs[1]).max() > 1e-3


def test_matches_the_per_token_loop():
    """≙ ``test_moe.py:34``: with nothing dropped each token's output is
    its top gate times its expert's FFN."""
    p = _inputs(1, s=6)
    out, aux = moe.moe_ffn(*(torch.tensor(p[n]) for n in NAMES),
                           num_experts=E, capacity_factor=8.0)
    xf = p["x"].reshape(-1, D)
    probs = torch.softmax(torch.tensor(xf @ p["router"]), -1).numpy()
    want = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        e = int(np.argmax(probs[t]))
        h = np.maximum(xf[t] @ p["w1"][e], 0.0)
        want[t] = probs[t, e] * (h @ p["w2"][e])
    np.testing.assert_allclose(out.numpy().reshape(-1, D), want,
                               rtol=1e-4, atol=1e-5)
    assert float(aux) > 0.0 and np.isfinite(float(aux))


def test_capacity_overflow_drops_tokens():
    """≙ ``test_moe.py:51``: every token routed to expert 0 at capacity
    ``ceil(8/4) = 2``: tokens 2..7 come out zero."""
    p = _inputs(2)
    router = np.zeros((D, E), np.float32)
    router[:, 0] = 1.0
    x = np.abs(np.random.default_rng(3).normal(size=(1, 8, D))) + 0.1
    out, _ = moe.moe_ffn(torch.tensor(x, dtype=torch.float32),
                         torch.tensor(router), torch.tensor(p["w1"]),
                         torch.tensor(p["w2"]), num_experts=E,
                         capacity_factor=1.0)
    norms = out[0].norm(dim=-1).numpy()
    assert (norms[:2] > 1e-6).all() and np.allclose(norms[2:], 0.0)


def _top2_construction():
    """≙ ``test_moe.py:395``: three token kinds whose logits are set
    exactly; round 1 overflows expert 0 and round 2's queue on expert 1
    starts after round 1's claims."""
    router = np.zeros((D, E), np.float32)
    router[0] = [2.0, 1.0, 0.0, -9.0]
    router[1] = [2.0, 0.0, 1.0, -9.0]
    router[2] = [0.0, 2.0, 1.0, -9.0]
    rows = ([[1.0, 0, 0] + [0.0] * (D - 3)] * 4
            + [[0, 1.0, 0] + [0.0] * (D - 3)] * 4
            + [[0, 0, 1.0] + [0.0] * (D - 3)] * 2)
    return np.asarray([rows], np.float32), router


def test_top2_overflow_to_second_choice_matches_the_reference():
    x, router = _top2_construction()
    p = _inputs(12)
    want, _ = ref_moe_ffn(x, router, p["w1"], p["w2"], num_experts=E,
                          capacity_factor=1.0, router_top_k=2)
    got, _ = moe.moe_ffn(torch.tensor(x), torch.tensor(router),
                         torch.tensor(p["w1"]), torch.tensor(p["w2"]),
                         num_experts=E, capacity_factor=1.0, router_top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_F32)
    # tokens 5-7 lost their first choice (expert 0) and kept their
    # second; tokens 3 and 9 lost their second: only they differ from
    # the loose form
    loose, _ = moe.moe_ffn(torch.tensor(x), torch.tensor(router),
                           torch.tensor(p["w1"]), torch.tensor(p["w2"]),
                           num_experts=E, capacity_factor=8.0,
                           router_top_k=2)
    diff = (got - loose)[0].norm(dim=-1).numpy()
    assert np.flatnonzero(diff > 1e-6).tolist() == [3, 5, 6, 7, 9]


def test_a_slot_past_capacity_is_an_all_zero_row():
    """``jax.nn.one_hot`` gives zeros past the end (capacity drops
    depend on it); the port's one-hot does too, where ``F.one_hot``
    would raise."""
    idx = torch.tensor([0, 2, 3, 7])
    got = moe._one_hot(idx, 3).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.nn.one_hot(np.asarray(idx), 3)))
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(idx, 3)


def test_ties_route_to_the_first_expert():
    x = torch.tensor([[0.2, 0.5, 0.5, 0.1], [0.3, 0.3, 0.3, 0.3],
                      [0.0, 0.0, 0.1, 0.1]])
    got = moe._first_argmax(x).tolist()
    assert got == np.asarray(jnp.argmax(x.numpy(), axis=-1)).tolist()
    assert got == [1, 0, 2]


@pytest.mark.parametrize("kw,match", [
    (dict(router_top_k=5), "must be in"),
    (dict(num_groups=3), "must divide into 3 token groups")])
def test_group_refusals_carry_the_reference_messages(kw, match):
    p = _inputs(0)
    args = [torch.tensor(p[n]) for n in NAMES]
    with pytest.raises(ValueError, match=match):
        moe.moe_ffn(*args, num_experts=E, **kw)
    with pytest.raises(ValueError, match=match):
        ref_moe_ffn(*(p[n] for n in NAMES), num_experts=E, **kw)


# -- the MoE transformer ------------------------------------------------------

LM = dict(vocab_size=31, model_dim=16, num_heads=2, num_layers=2,
          max_seq_len=16, num_experts=4)
MOE_KW = dict(capacity_factor=1.25, moe_num_groups=2, moe_router_top_k=2)


def _lm():
    params = jax.tree.map(np.asarray, ref_transformer.init(
        jax.random.PRNGKey(3), **LM))
    toks = np.random.default_rng(5).integers(0, 31, (2, 16)).astype(
        np.int32)
    return params, toks


def _ref_lm(params, toks, remat=False, policy="full"):
    def loss(p):
        logits, aux = ref_transformer.apply(
            p, toks, num_heads=2, compute_dtype=jnp.float32, num_experts=4,
            capacity_factor=MOE_KW["capacity_factor"],
            moe_num_groups=MOE_KW["moe_num_groups"],
            moe_router_top_k=MOE_KW["moe_router_top_k"], remat=remat,
            remat_policy=policy, return_aux=True)
        return ref_transformer.loss_fn(logits, toks) + 0.01 * aux, (logits,
                                                                     aux)
    (_, (logits, aux)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    return np.asarray(logits), float(aux), jax.tree.leaves(grads)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "save_attn")])
def test_moe_transformer_matches_the_reference(remat, policy):
    """Logits, the summed aux and every parameter's gradient of ``loss +
    0.01·aux`` (float32, capacity binding: 1.25 at top-2 in 2 groups of
    8), at the reference test's update tolerance; remat recomputes the
    MoE sublayer as the reference's ``jax.checkpoint`` does."""
    params, toks = _lm()
    want_logits, want_aux, want_grads = _ref_lm(params, toks, remat, policy)
    p = params_from_reference(params, device="cpu")
    leaves = jax.tree.leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    groups = transformer.MoeGroups(
        num_experts=4, capacity_factor=MOE_KW["capacity_factor"],
        router_top_k=MOE_KW["moe_router_top_k"],
        num_groups=MOE_KW["moe_num_groups"], expert_group=None,
        reduce_group=None, stats_group=None)
    logits, aux = transformer.apply(p, torch.tensor(toks), num_heads=2,
                                    compute_dtype=torch.float32,
                                    remat=remat, remat_policy=policy,
                                    moe=groups, return_aux=True)
    loss = transformer.loss_fn(logits, torch.tensor(toks)) + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=1e-6)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-5)


def test_moe_params_without_groups_are_refused():
    params, toks = _lm()
    p = params_from_reference(params, device="cpu")
    with pytest.raises(ValueError, match="apply\\(moe="):
        transformer.apply(p, torch.tensor(toks), num_heads=2)


def test_init_has_the_reference_layout():
    """``init(num_experts=E)`` gives the reference's leaves and shapes
    (``router [d, E]``, ``w1 [E, d, 4d]``, ``w2 [E, 4d, d]``)."""
    ref = ref_transformer.init(jax.random.PRNGKey(0), **LM)
    got = transformer.init(torch.Generator().manual_seed(0), **LM)
    assert (jax.tree.structure(jax.tree.map(np.shape, ref))
            == jax.tree.structure(jax.tree.map(lambda t: tuple(t.shape),
                                               got)))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
