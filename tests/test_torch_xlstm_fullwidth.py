"""xLSTM-350M's gradient at its published widths, on the CPU, against the
JAX package.

The JAX ``LM.init`` draws the model, ``repro_torch.bridge`` carries the
weights over, and each package takes one ``LM.loss`` gradient at B=1,
S=256 (one of the reference's mLSTM chunks) on the same numpy tokens.

- fp32, as both packages compute it, at full size (24 layers: 21 mLSTM, 3
  sLSTM; 518,640,808 parameters, 2.1 GB): each package's per-layer
  gradient norms against the reference's in fp64 (``EXACT_*``, which
  ``report()`` recomputes and checks: at full size the reference's fp64
  gradient takes another ~5 GB and ~40 s). At random init the
  gradient grows ~6e6x from the last layer to the first, and fp32
  rounding grows with it, so the fp32 gradients of the first layers are
  not determined to a few digits in either package. The test holds the
  losses and the norms of the unembedding, the final norm and the last
  layer within 1e-2; every layer of the reference within ``REF_BAND`` of
  fp64 and every layer of the port within ``PORT_BAND`` (a missing or
  miswired layer is off by more); and the port's known excess rounding
  (ROADMAP §C, C3) as ``C3_GMEAN``, so that a fix or a worsening of C3
  fails the test (``python tests/test_torch_xlstm_fullwidth.py`` prints
  every layer's norms).
- fp64 throughout, at full width and one repeat of the layer pattern (8
  layers: 7 mLSTM, 1 sLSTM): with the fp32 casts inside both models (the
  mLSTM's and sLSTM's inputs and state, the loss's logits) made fp64 for
  the test (by patching the casts' dtype where the models look it up:
  neither package's files change), the gradients agree leaf by leaf within
  1e-6 of max(1, max |g|): the port computes the reference's function at
  full width, and the fp32 differences are rounding.

Marked slow: the fp32 test builds the full weights in both packages
(about 30 s and a peak near 8.6 GB); the fp64 test takes about 25 s.
"""
import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.api as jax_api  # noqa: E402
import repro.models.layers as jax_layers  # noqa: E402
import repro.models.xlstm as jax_xlstm  # noqa: E402
import repro_torch.models.xlstm as port_xlstm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.params import (flatten, layer_of, rebuild,  # noqa: E402
                                      unbind_layers)

pytestmark = pytest.mark.slow

ARCH = "xlstm_350m"
SEQ = 256
LAYERS = 24        # the published depth
PATTERN = 8        # one repeat of the layer pattern (slstm_every)
# fp32 / fp64 of each layer's gradient norm at full size (measured: the
# reference 0.82-1.63, the port 0.90-1.85)
REF_BAND = (0.75, 1.75)
PORT_BAND = (0.5, 2.0)
# C3: over the first repeat's eight layers, where the gradient is largest,
# the geometric mean of fp32 / fp64 is 1.21 in the reference and 1.50 in
# the port with torch's CPU matrix products on ``PORT_THREADS`` threads.
# It is no fault of the port (ROADMAP §C, "Not faults"): the thread count
# alone moves it from 1.02 to 1.59, by the order of the products' sums, and
# with every product rounded once from fp64 it is 0.85 on any thread count
# (``python tests/test_torch_xlstm_fullwidth.py --c3``). The band holds the
# value at those threads, so that a change of the port's arithmetic shows.
C3_GMEAN = (1.35, 1.75)
REF_GMEAN_MAX = 1.3
PORT_THREADS = 8   # torch's CPU threads for the port's fp32 gradient
# the reference's fp64 gradient at full size on this input (``report()``
# recomputes it): the loss, each layer's gradient norm (repeat by repeat,
# slot by slot), the unembedding's and the final norm's
EXACT_LOSS = 11.289216724505536
EXACT_LAYER_NORMS = (
    728948.2, 236194.8, 76423.95, 30664.63, 12941.2, 6926.879, 3577.713,
    130.1041, 1492.268, 997.3386, 486.6395, 318.3669, 177.9374, 119.9455,
    62.80543, 2.870204, 44.3153, 33.48927, 19.81384, 12.76986, 7.881983,
    5.639818, 3.682441, 0.1279502)
EXACT_NORMS = {"unembed": 2.003961, "final_norm/w": 7.098618e-02}


class _Dtypes:
    """A module's stand-in that forwards every attribute but ``float32``."""

    def __init__(self, module, float32):
        self._module, self.float32 = module, float32

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def _in_fp64():
    """Both models' fp32 casts made fp64, and JAX's 64-bit types on."""
    with contextlib.ExitStack() as stack:
        for module in (jax_api, jax_layers, jax_xlstm):
            stack.enter_context(mock.patch.object(
                module, "jnp", _Dtypes(jnp, jnp.float64)))
        stack.enter_context(mock.patch.object(
            port_xlstm, "torch", _Dtypes(torch, torch.float64)))
        stack.enter_context(mock.patch.object(torch.Tensor, "float",
                                              torch.Tensor.double))
        stack.enter_context(jax.enable_x64(True))
        yield


def _model(n_layers):
    """(JAX LM, its fp32 params, the port's config, the params flattened to
    numpy, the numpy batch) at full width and ``n_layers``."""
    jcfg, cfg = (dataclasses.replace(c, n_layers=n_layers)
                 for c in (jax_config(ARCH), get_config(ARCH)))
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(1))
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (1, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    return jlm, jparams, cfg, flat, {"tokens": toks, "labels": labels}


def _jax_grads(jlm, jparams, batch, dtype):
    """(loss, {leaf: numpy gradient in ``dtype``}) of the JAX ``LM.loss``."""
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), jparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb, remat=False)))(jparams)
    assert loss.dtype == dtype
    return float(loss), {k: np.asarray(v) for k, v in _flatten(grads).items()}


def _jax_sq(jlm, jparams, batch, dtype):
    """(loss, {leaf: squared norms of its slices along axis 0, float64}) of
    the JAX ``LM.loss`` gradient with the params cast to ``dtype``. The
    gradient is reduced inside the jitted function, so it never stands
    whole beside the params."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def sq(g):
        return jnp.sum(jnp.square(g), axis=tuple(range(1, g.ndim)))

    def f(p):
        p = jax.tree_util.tree_map(lambda x: x.astype(dtype), p)
        loss, g = jax.value_and_grad(
            lambda p: jlm.loss(p, jb, remat=False))(p)
        return loss, jax.tree_util.tree_map(sq, g)
    loss, out = jax.jit(f)(jparams)
    assert loss.dtype == dtype
    return float(loss), {k: v.astype(np.float64)
                         for k, v in _flatten(out).items()}


@contextlib.contextmanager
def _threads(n):
    """torch's CPU ops on ``n`` threads inside the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _port_grads(cfg, params, batch, threads=PORT_THREADS):
    """(loss, {leaf: numpy gradient in the params' dtype}) of the port's
    ``LM.loss``, torch on ``threads`` CPU threads."""
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _threads(threads):
        loss = LM(cfg).loss(rebuild(params, leaves.values()), tb,
                            remat=False)
        assert loss.dtype == next(iter(leaves.values())).dtype
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(leaves, grads)}


def _sq(g):
    """Squared norms of a numpy gradient's slices along axis 0."""
    return np.sum(np.square(g, dtype=np.float64), axis=tuple(range(1, g.ndim)))


def _norm(sq):
    return float(np.sqrt(np.sum(sq)))


def _layer_norms(sqs):
    """{(repeat, slot): norm of that layer's gradient} from ``_sq`` of each
    leaf; the layers' leaves are stacked over the pattern's repeats (axis
    0) under slots/<slot>/."""
    out = {}
    for key, sq in sqs.items():
        if key.startswith("slots/"):
            slot = int(key.split("/")[1])
            for rep, s in enumerate(sq):
                out[rep, slot] = out.get((rep, slot), 0.0) + float(s)
    return {k: v ** 0.5 for k, v in out.items()}


def _fp32_norms():
    """(loss, {leaf: ``_sq``}) of the port and of the reference in fp32 at
    full size; the port's weights are built after the reference's gradient
    is reduced."""
    jlm, jparams, cfg, flat, batch = _model(LAYERS)
    theirs = _jax_sq(jlm, jparams, batch, jnp.float32)
    params = params_from_numpy(flat, cfg, "cpu")
    del jparams, flat   # flat's arrays are views of the JAX weights
    loss, grads = _port_grads(cfg, params, batch)
    return (loss, {k: _sq(g) for k, g in grads.items()}), theirs


def _in_fp64_rounded(fn):
    """``fn`` computed on its fp32 tensors lifted to fp64, its fp32
    results rounded once back to fp32."""
    def lift(x, to):
        if isinstance(x, (tuple, list)):
            return type(x)(lift(v, to) for v in x)
        if isinstance(x, dict):
            return {k: lift(v, to) for k, v in x.items()}
        if torch.is_tensor(x) and x.dtype in (torch.float32, torch.float64):
            return x.to(to)
        return x

    def run(*args):
        return lift(fn(*lift(args, torch.float64)), torch.float32)
    return run


def _c3_groups():
    """{name: patches}: the port's op groups, each lifted to fp64 on its
    own (its inputs and outputs stay fp32), and ``products``: every fp32
    matrix product (``@`` and ``einsum``) computed in fp64 and rounded
    once to fp32, so that no product depends on the order of its sums."""
    import repro_torch.models.layers as port_layers
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

    logits = port_xlstm.logits

    def lifted_logits(params, x, cfg):   # lifts only the leaves it reads
        used = {k: params[k] for k in ("final_norm", "unembed")}
        return _in_fp64_rounded(lambda p, x: logits(p, x, cfg))(used, x)

    def product(fn):
        def run(*args):
            if all(not torch.is_tensor(a) or a.dtype == torch.float32
                   for a in args):
                return _in_fp64_rounded(fn)(*args)
            return fn(*args)
        return run
    return {
        "mLSTM chunk scan": [(port_xlstm, "mlstm_chunk",
                              _in_fp64_rounded(mlstm_chunk_ref))],
        "q/k/v and gate projections": [
            (port_xlstm, "_mlstm_qkvif",
             _in_fp64_rounded(port_xlstm._mlstm_qkvif))],
        "sLSTM step": [(port_xlstm, "_slstm_step",
                        _in_fp64_rounded(port_xlstm._slstm_step))],
        "norms": [(port_layers, "apply_norm",
                   _in_fp64_rounded(port_layers.apply_norm))],
        "final norm and logits": [(port_xlstm, "logits", lifted_logits)],
        "products": [(torch.Tensor, "__matmul__",
                      product(torch.Tensor.__matmul__)),
                     (torch, "einsum", product(torch.einsum))],
    }


def _layer_outputs(jlm, jparams, cfg, flat, batch):
    """Each layer's output in the forward at full size: the reference's
    in fp64 (its casts lifted) and in fp32, the port's in fp32 on
    ``PORT_THREADS`` threads, as float64 numpy (B, S, D) arrays."""
    jcfg, kinds = jlm.cfg, port_xlstm._slot_kinds(cfg)
    groups = len(jcfg.layer_kinds()) // len(kinds)

    def reference(dtype):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                        jparams)
        states = jax_xlstm.init_cache(jcfg, 1, 0, dtype)["slots"]
        blocks = {kind: jax.jit(lambda p, x, st, kind=kind: (
            jax_xlstm._mlstm_block if kind == "mlstm"
            else jax_xlstm._slstm_block)(p, x, jcfg, st, "train")[0])
            for kind in set(kinds)}
        x = jax_xlstm._embed(params, jnp.asarray(batch["tokens"]))
        outs = []
        for g in range(groups):
            for i, kind in enumerate(kinds):
                p, st = jax.tree_util.tree_map(
                    lambda a: a[g], (params["slots"][i], states[i]))
                x = blocks[kind](p, x, st)
                outs.append(np.asarray(x, np.float64))
        return outs
    with _in_fp64():
        exact = reference(jnp.float64)
    theirs = reference(jnp.float32)
    params = params_from_numpy(flat, cfg, "cpu")
    states = port_xlstm.init_cache(cfg, 1, 0, device="cpu")["slots"]
    slots = unbind_layers(params["slots"])
    ours = []
    with torch.no_grad(), _threads(PORT_THREADS):
        x = params["embed"][torch.from_numpy(batch["tokens"]).long()]
        for g in range(groups):
            for i, kind in enumerate(kinds):
                block = port_xlstm._mlstm_block if kind == "mlstm" else \
                    port_xlstm._slstm_block
                x = block(layer_of(slots, g)[i], x, cfg,
                          layer_of(states[i], g), "train")
                ours.append(x.double().numpy())
    return exact, theirs, ours


def c3_report():
    """The numbers behind ROADMAP §C's C3 at full size, in fp32 against
    the reference's fp64: each layer's output in the forward (its relative
    error in each package, and the port's over the reference's); each
    package's loss error and first-repeat geometric mean of the layers'
    gradient norms (against ``EXACT_*``); the port's on 1, 2, 4 and 8
    torch threads; with one op group at a time lifted to fp64
    (``_c3_groups``) on 8 threads, the mLSTM chunk scan also on 1 and 4;
    and with every matrix product rounded once from fp64 on 1, 4 and 8 (a
    full-size gradient each, ~9 GB; about four minutes in all)."""
    jlm, jparams, cfg, flat, batch = _model(LAYERS)
    exact, theirs, ours = _layer_outputs(jlm, jparams, cfg, flat, batch)
    for i, (e, t, o) in enumerate(zip(exact, theirs, ours)):
        ref, port = (float(np.linalg.norm(a - e) / np.linalg.norm(e))
                     for a in (t, o))
        print(f"forward, layer {i:2d}: fp32 relative error reference "
              f"{ref:.3e}, port {port:.3e} ({port / ref:.2f}x)", flush=True)
    del exact, theirs, ours
    groups = _c3_groups()
    first = [(0, slot) for slot in range(PATTERN)]

    def show(who, loss, sqs):
        norms = _layer_norms(sqs)
        enorms = dict(zip(sorted(norms), EXACT_LAYER_NORMS, strict=True))
        print(f"{who}: loss {loss - EXACT_LOSS:+.3e} off fp64; first-repeat "
              "geometric mean of fp32 / fp64 "
              f"{_gmean([norms[k] / enorms[k] for k in first]):.4f}",
              flush=True)
    show("reference", *_jax_sq(jlm, jparams, batch, jnp.float32))
    params = params_from_numpy(flat, cfg, "cpu")
    del jparams, flat
    runs = [(n, None) for n in (1, 2, 4, 8)] + \
        [(8, g) for g in groups] + \
        [(n, "mLSTM chunk scan") for n in (1, 4)] + \
        [(n, "products") for n in (1, 4)]
    for threads, group in runs:
        with contextlib.ExitStack() as stack:
            for owner, name, fn in groups.get(group, []):
                stack.enter_context(mock.patch.object(owner, name, fn))
            loss, grads = _port_grads(cfg, params, batch, threads=threads)
        show(f"port, {threads} threads"
             f"{', ' + group + ' in fp64' if group else ''}", loss,
             {k: _sq(g) for k, g in grads.items()})
        del grads


def _exact_norms():
    """The loss and {layer | leaf: norm} of the reference's fp64 gradient at
    full size (its casts lifted as in the fp64 test)."""
    jlm, jparams, _, _, batch = _model(LAYERS)
    with _in_fp64():
        loss, sq = _jax_sq(jlm, jparams, batch, jnp.float64)
    return loss, {**_layer_norms(sq),
                  **{k: _norm(sq[k]) for k in EXACT_NORMS}}


def _gmean(ratios):
    return float(np.exp(np.mean(np.log(ratios))))


def test_fullwidth_fp32_gradient_norms():
    (loss, sq), (jloss, jsq) = _fp32_norms()
    assert sorted(sq) == sorted(jsq)
    assert abs(loss - EXACT_LOSS) < 1e-2 and abs(jloss - EXACT_LOSS) < 1e-2
    norms, jnorms = _layer_norms(sq), _layer_norms(jsq)
    assert sorted(norms) == sorted(jnorms)
    enorms = dict(zip(sorted(norms), EXACT_LAYER_NORMS, strict=True))
    last = max(norms)
    for key in (*EXACT_NORMS, last):   # next to the loss
        e = enorms[last] if key == last else EXACT_NORMS[key]
        for s, n in ((sq, norms), (jsq, jnorms)):
            got = n[key] if key == last else _norm(s[key])
            assert abs(got - e) <= 1e-2 * e, key
    ratio = {layer: norms[layer] / enorms[layer] for layer in enorms}
    jratio = {layer: jnorms[layer] / enorms[layer] for layer in enorms}
    for layer in enorms:
        assert REF_BAND[0] < jratio[layer] < REF_BAND[1], (layer, jratio)
        assert PORT_BAND[0] < ratio[layer] < PORT_BAND[1], (layer, ratio)
    first = [(0, slot) for slot in range(PATTERN)]
    gmean, jgmean = (_gmean([r[layer] for layer in first])
                     for r in (ratio, jratio))
    assert jgmean < REF_GMEAN_MAX, jgmean
    assert C3_GMEAN[0] < gmean < C3_GMEAN[1], (
        f"C3: the port's fp32 first-repeat norms are {gmean:.3f}x the fp64 "
        f"ones (the reference's {jgmean:.3f}x); ROADMAP §C records 1.50x")


def test_fullwidth_fp64_gradients_match():
    jlm, jparams, cfg, flat, batch = _model(PATTERN)
    with _in_fp64():
        jloss, jgrads = _jax_grads(jlm, jparams, batch, jnp.float64)
        loss, grads = _port_grads(
            cfg, params_from_numpy(flat, cfg, "cpu", dtype=torch.float64),
            batch)
    assert abs(loss - jloss) < 1e-9
    assert sorted(grads) == sorted(jgrads)
    for key, g in grads.items():
        assert g.dtype == jgrads[key].dtype == np.float64, key
        scale = max(1.0, float(np.max(np.abs(jgrads[key]))))
        assert float(np.max(np.abs(g - jgrads[key]))) <= 1e-6 * scale, key


def report():
    """The numbers behind the tests: the fp32 losses and per-layer gradient
    norms of both packages at full size beside the reference's in fp64
    (its casts lifted as in the fp64 test), with the first repeat's
    geometric means of fp32 / fp64, and the fp64 agreement of the two at 8
    layers. Checks the ``EXACT_*`` constants against the fp64 gradient
    (~13 GB, a few minutes)."""
    eloss, exact = _exact_norms()
    stored = {**dict(zip(sorted(k for k in exact if k not in EXACT_NORMS),
                         EXACT_LAYER_NORMS)), **EXACT_NORMS}
    worst = max(abs(stored[k] / v - 1) for k, v in exact.items())
    print(f"EXACT_*: loss {EXACT_LOSS!r} against {eloss!r}; norms within "
          f"{worst:.3g} (stored to 7 digits)")
    (loss, sq), (jloss, jsq) = _fp32_norms()
    print(f"loss: port fp32 {loss!r}, reference fp32 {jloss!r}, reference "
          f"fp64 {eloss!r}")
    norms, jnorms = _layer_norms(sq), _layer_norms(jsq)
    enorms = exact
    for i, layer in enumerate(sorted(norms)):
        print(f"layer {i:2d} {layer}: gradient norm port fp32 "
              f"{norms[layer]:.5e} ({norms[layer] / enorms[layer]:.3f}x), "
              f"reference fp32 {jnorms[layer]:.5e} "
              f"({jnorms[layer] / enorms[layer]:.3f}x), reference fp64 "
              f"{enorms[layer]:.5e}")
    first = [(0, slot) for slot in range(PATTERN)]
    print("first repeat, geometric mean of fp32 / fp64: port "
          f"{_gmean([norms[k] / enorms[k] for k in first]):.4f}, reference "
          f"{_gmean([jnorms[k] / enorms[k] for k in first]):.4f}")
    for key in ("unembed", "final_norm/w"):
        print(f"{key}: port fp32 {_norm(sq[key]):.6e}, reference fp32 "
              f"{_norm(jsq[key]):.6e}, reference fp64 {exact[key]:.6e}")
    jlm, jparams, cfg, flat, batch = _model(PATTERN)
    with _in_fp64():
        jloss, jgrads = _jax_grads(jlm, jparams, batch, jnp.float64)
        loss, grads = _port_grads(
            cfg, params_from_numpy(flat, cfg, "cpu", dtype=torch.float64),
            batch)
    worst = max(float(np.max(np.abs(g - jgrads[k]))) /
                max(1.0, float(np.max(np.abs(jgrads[k]))))
                for k, g in grads.items())
    print(f"fp64, {PATTERN} layers: losses {loss!r} / {jloss!r}; worst leaf "
          f"max |port - reference| / max(1, max |reference|) {worst:.3g}")


if __name__ == "__main__":
    import sys
    c3_report() if sys.argv[1:] == ["--c3"] else report()
