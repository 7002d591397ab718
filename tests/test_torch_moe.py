"""The port's MoE FFN (``repro_torch.models.moe_layer``) against
``repro.models.moe_layer`` on the CPU.

Routing: the JAX function's own dispatch and combine tensors, taken from
the operands of its einsums, against the ones the port's ``route`` gives
for the same fp32 gates. The gates are fed in through a router that is the
identity (d_model = E), so the logits are the drawn inputs exactly and both
sides soften the same array. Dispatch (which expert, which slot, whether it
fits) must be equal; combine within 1e-6 and the aux loss within 1e-6 (fp32
sums in another order). Cases: capacity drops, dropless, a padded last
group, and ties between gates (the first index wins on both sides).

``moe_forward``: the reduced phi3.5-moe (top-2) and llama4-maverick (top-1,
shared expert) on the JAX weights, with drops (the tokens lean towards one
expert, which overflows) and dropless, over whole and padded groups;
output within 1e-5 and aux within 1e-6 (fp32, other sum orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe_layer as jax_moe  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.moe_layer import capacity, moe_forward, route  # noqa: E402
from repro_torch.models.params import unflatten  # noqa: E402

E = 8


class _Capture:
    """Stands in for ``jnp`` inside ``repro.models.moe_layer`` and records
    the operands of its einsums (the dispatch and combine tensors)."""

    def __init__(self):
        self.einsums = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops):
        self.einsums[spec] = ops
        return jnp.einsum(spec, *ops)


def _jax_routing(monkeypatch, cfg, x, dropless):
    """(dispatch (N, g, E, C), combine, aux) of the JAX moe_forward for
    tokens x (B, S, E) through an identity router."""
    params = jax_moe.init_moe(jax.random.key(0), cfg, jnp.float32)
    params["router"] = jnp.eye(cfg.n_experts, dtype=jnp.float32)
    cap = _Capture()
    monkeypatch.setattr(jax_moe, "jnp", cap)
    _, aux = jax_moe.moe_forward(params, jnp.asarray(x), cfg,
                                 dropless=dropless)
    monkeypatch.undo()
    dispatch = np.asarray(cap.einsums["ngd,ngec->ecnd"][1])
    combine = np.asarray(cap.einsums["ecnd,ngec->ngd"][1])
    return dispatch, combine, float(aux)


def _dense(r, C):
    """The port's routing as the reference's dense (N, g, E, C) tensors."""
    N, g, k = r.expert.shape
    dispatch = np.zeros((N, g, E, C), np.float32)
    combine = np.zeros((N, g, E, C), np.float32)
    for n, t, j in np.ndindex(N, g, k):
        if r.fits[n, t, j]:
            e, c = int(r.expert[n, t, j]), int(r.slot[n, t, j])
            dispatch[n, t, e, c] += 1
            combine[n, t, e, c] += float(r.weight[n, t, j])
    return dispatch, combine


def _router_cfg(top_k, group, capacity_factor):
    """A config whose tokens are the router's logits (d_model = E)."""
    return dataclasses.replace(
        jax_config("phi3_5_moe").reduced(), d_model=E, d_ff=8, n_experts=E,
        top_k=top_k, moe_group_size=group, capacity_factor=capacity_factor)


# (top_k, group size, capacity factor (None: dropless), tokens B x S, ties)
ROUTING_CASES = {
    "drops": (2, 32, 1.0, (2, 32), False),
    "drops_top1": (1, 16, 0.5, (1, 64), False),
    "dropless": (2, 16, None, (2, 16), False),
    "padded_last_group": (2, 16, 1.25, (1, 40), False),
    "ties": (2, 16, 1.0, (2, 16), True),
}


@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing_matches_jax(monkeypatch, case):
    top_k, group, cf, (B, S), ties = ROUTING_CASES[case]
    dropless = cf is None
    cfg = _router_cfg(top_k, group, cf or 1.25)
    rng = np.random.default_rng(sorted(ROUTING_CASES).index(case))
    # skewed logits, so some experts overflow their capacity
    x = (rng.standard_normal((B, S, E)) +
         np.linspace(1.5, 0, E)).astype(np.float32)
    if ties:   # a tie for the first place, and one for the second
        x[0, :4, 3] = x[0, :4, 5] = x[0, :4].max() + 1.0
        x[1, :4, 2] = x[1, :4, 6] = x[1, :4].min() - 1.0
        x[1, :4, 4] = x[1, :4, 7] = x[1, :4].max() + 1.0
        x[1, 4:8, 0] = x[1, 4:8].max() + 1.0
        x[1, 4:8, 1] = x[1, 4:8, 2] = x[1, 4:8, 0] - 0.5
    dispatch, combine, aux = _jax_routing(monkeypatch, cfg, x, dropless)
    # the port's routing on the same gates (padded with zero tokens, as
    # moe_forward pads them)
    T = B * S
    g = min(group, T)
    N = -(-T // g)
    xg = np.zeros((N * g, E), np.float32)
    xg[:T] = x.reshape(T, E)
    gates = np.array(jax.nn.softmax(
        jnp.asarray(xg.reshape(N, g, E)) @ jnp.eye(E, dtype=jnp.float32),
        axis=-1))
    C = g if dropless else capacity(g, cfg)
    assert dispatch.shape == (N, g, E, C)
    r = route(torch.from_numpy(gates), top_k, C)
    ours_d, ours_c = _dense(r, C)
    assert np.array_equal(ours_d, dispatch)
    assert np.max(np.abs(ours_c - combine)) < 1e-6
    assert abs(float(r.aux) - aux) < 1e-6
    n_fit = int(r.fits.sum())
    if dropless:
        assert n_fit == N * g * top_k
    elif case != "ties":       # capacity drops engaged
        assert n_fit < N * g * top_k, n_fit
    if ties:   # the first index wins, on both sides
        assert (r.expert[0, :4, 0] == 3).all() and \
            (r.expert[0, :4, 1] == 5).all()
        assert (r.expert[1, 4:8, 1] == 1).all()


def _moe_pair(arch, seed=0):
    """(JAX config, JAX MoE params, port config, port params), reduced."""
    jcfg = jax_config(arch).reduced()
    jparams = jax_moe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    params = unflatten({k: torch.from_numpy(np.array(v))
                        for k, v in _flatten(jparams).items()})
    return jcfg, jparams, get_config(arch).reduced(), params


@pytest.mark.parametrize("arch", ["phi3_5_moe", "llama4_maverick"])
@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("B,S", [(2, 64), (3, 50)])
def test_moe_forward_matches_jax(arch, dropless, B, S):
    jcfg, jparams, cfg, params = _moe_pair(arch)
    assert ("shared" in params) == cfg.shared_expert
    # tokens leaning towards expert 0, so that it overflows without dropless
    lean = params["router"][:, 0] / params["router"][:, 0].norm()
    x = (np.random.default_rng(B).standard_normal((B, S, cfg.d_model)) +
         8.0 * lean.numpy()).astype(np.float32)
    if not dropless:
        T = B * S
        g = min(cfg.moe_group_size, T)
        xg = torch.nn.functional.pad(torch.from_numpy(x).reshape(T, -1),
                                     (0, 0, 0, -T % g)).reshape(-1, g,
                                                                cfg.d_model)
        r = route(torch.softmax(xg @ params["router"], -1), cfg.top_k,
                  capacity(g, cfg))
        assert not r.fits.all()
    jout, jaux = jax.jit(jax_moe.moe_forward, static_argnums=(2, 3))(
        jparams, jnp.asarray(x), jcfg, dropless)
    out, aux = moe_forward(params, torch.from_numpy(x), cfg,
                           dropless=dropless)
    assert out.shape == (B, S, cfg.d_model)
    assert float(np.max(np.abs(out.numpy() - np.asarray(jout)))) < 1e-5
    assert abs(float(aux) - float(jaux)) < 1e-6
