"""PyTorch port vs the JAX reference: what the modal families (enc_dec,
vlm) share.

`layers.cross_attention` with and without a key mask and QKV bias, and
`launch.serve.serve` with given and drawn modal embeddings; then the
helpers and checks that tests/test_torch_enc_dec.py and
tests/test_torch_vlm.py run on their family's configs.

Every cross block's ``gate`` is drawn as zero in both packages, and a cross
block adds ``tanh(gate) * cross_attention``: at init neither the
cross-attention nor, for enc_dec, the encoder reaches the logits.  So every
comparison sets each gate leaf of the reference's tree to a draw from a
numpy seed (uniform in [0.5, 1.0]) before both packages run.  Tolerances:
1e-5 in float32 for a layer, 1e-4 for whole prefills, caches, decodes and
losses after a step; greedy ids exactly equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, registry, transformer  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)          # one layer in float32
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # whole prefills, caches, decodes


def tiny(family):
    """The reference's tiny configs of its family tests
    (tests/test_models.py), in both packages: (reference, port)."""
    kw = dict(name=f"tiny-{family}", family=family, n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab=97)
    kw.update({"enc_dec": dict(n_enc_layers=2, enc_seq=8, norm="layernorm",
                               act="gelu"),
               "vlm": dict(n_layers=4, cross_attn_every=2,
                           n_modal_tokens=8)}[family])
    return jT.ModelCfg(**kw), transformer.ModelCfg(**kw)


def smoke(arch):
    """The architecture's smoke variant in both packages."""
    return (jbase.smoke_variant(jbase.get(arch)),
            base.smoke_variant(base.get(arch)))


def np32(x):
    return np.array(x.detach().float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


def tree(jtree):
    return interop.params_from_jax(jax.tree.map(np.asarray, jtree))


def gated(jparams, seed):
    """The reference tree with every ``gate`` leaf drawn uniform in
    [0.5, 1.0] from ``seed`` (in the leaf's dtype)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key != "gate":
            return leaf
        return jnp.asarray(rng.uniform(0.5, 1.0, size=leaf.shape), leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, jparams)


def weights(jcfg, seed=0, gate_seed=100):
    """The reference's init at ``seed`` with its gates set, and the same
    tree in the port."""
    jp = gated(jT.init_params(jax.random.PRNGKey(seed), jcfg), gate_seed)
    return jp, tree(jp)


def modal_input(cfg, batch, seed):
    t = transformer.modal_len(cfg)
    return np.random.default_rng(seed).normal(
        size=(batch, t, cfg.d_model)).astype(np.float32)


def same_cfg(cfg, jcfg):
    for f in dataclasses.fields(jcfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            want = {"float32": torch.float32,
                    "bfloat16": torch.bfloat16}[jnp.dtype(want).name]
        assert got == want, f.name
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]


def shapes_match_reference(jcfg, cfg):
    """The port's `init_params` leaves (names, order, shapes, dtypes)
    against `jax.eval_shape` of the reference's, nothing allocated (the
    port's under `FakeTensorMode`).  Returns the parameter count."""
    jshapes = tree_shapes(jax.eval_shape(
        lambda k: jT.init_params(k, jcfg), jax.random.PRNGKey(0)))
    with FakeTensorMode():
        own = transformer.init_params(torch.Generator().manual_seed(0), cfg)
        got = [(k, tuple(v.shape), v.dtype) for k, v in own.items()]
    want = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    assert got == [(k, s, want[d]) for k, s, d in jshapes]
    return sum(int(np.prod(s)) for _, s, _ in jshapes)


def tree_shapes(jtree, prefix=""):
    """(dotted name, shape, dtype name) of a reference tree's leaves in
    flattening order."""
    out = []
    for k in sorted(jtree):
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(jtree[k], dict):
            out += tree_shapes(jtree[k], name)
        else:
            out.append((name, tuple(jtree[k].shape),
                        jnp.dtype(jtree[k].dtype).name))
    return out


def jbatch(jcfg, tokens, modal):
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    if jregistry.needs_modal(jcfg):
        batch["modal_embeds"] = jnp.asarray(modal)
    return batch


def grow_ref(jcache, total):
    """The reference's `main` growth of ``k`` / ``v`` along axis -3."""
    out = dict(jcache)
    for name in ("k", "v"):
        pad = [(0, 0)] * jcache[name].ndim
        pad[-3] = (0, total - jcache[name].shape[-3])
        out[name] = jnp.pad(jcache[name], pad)
    return out


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kv_mask"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "qkv_bias"])
def test_cross_attention_matches_reference(bias, masked):
    """Queries from x (B, S, D), keys and values from another sequence of
    another length (B, T, D), GQA 2, no RoPE; the bias added per head; a
    (B, T) key mask that hides a different set of keys in each row."""
    kw = dict(d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
              qkv_bias=bias, causal=False)
    jcfg, cfg = jL.AttnCfg(**kw), layers.AttnCfg(**kw)
    jp = jL.init_attention(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    if bias:   # the reference draws biases as zeros
        jp = {k: (jnp.asarray(rng.normal(size=v.shape), v.dtype)
                  if k.startswith("b") else v) for k, v in jp.items()}
    tp = tree(jp)
    assert list(tp) == list(layers.init_attention(
        torch.Generator().manual_seed(0), cfg))
    x = rng.normal(size=(2, 7, 48)).astype(np.float32)
    src = rng.normal(size=(2, 11, 48)).astype(np.float32)
    mask = rng.random((2, 11)) < 0.6 if masked else None
    if masked:
        mask[:, 0] = True
    want = jL.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(src),
                              kv_mask=None if mask is None
                              else jnp.asarray(mask))
    got = layers.cross_attention(tp, cfg, torch.from_numpy(x),
                                 torch.from_numpy(src),
                                 kv_mask=None if mask is None
                                 else torch.from_numpy(mask))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    # Given its own unbiased projections it gives the same.
    kv = layers.cross_kv(tp, cfg, torch.from_numpy(src))
    again = layers.cross_attention(tp, cfg, torch.from_numpy(x),
                                   torch.from_numpy(src), kv=kv,
                                   kv_mask=None if mask is None
                                   else torch.from_numpy(mask))
    assert torch.equal(again, got)
    assert tuple(kv[0].shape) == (2, 11, 2, 12)


# ---------------------------------------------------------------------------
# Modal inputs through launch.serve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_serve_with_given_and_drawn_modal_embeddings(arch):
    """`serve` prefills given embeddings as given; without them it draws a
    float32 standard normal (B, T, D) from the third child of the seed's
    `SeedSequence`, so the weights and prompts stay those of the first two
    (a non-modal config's `serve` draws the same ones)."""
    cfg = base.smoke_variant(base.get(arch))
    kw = dict(batch=2, prompt_len=6, gen=3, device="cpu", seed=4)
    drawn = serve.serve(cfg, **kw)
    s_params, s_tokens, s_modal = serve._seeds(4)
    want = torch.randn((2, transformer.modal_len(cfg), cfg.d_model),
                       generator=torch.Generator().manual_seed(s_modal))
    assert drawn.modal.dtype == torch.float32
    assert torch.equal(drawn.modal, want)
    kids = np.random.SeedSequence(4).spawn(2)
    assert (s_params, s_tokens) == tuple(
        int(k.generate_state(1, dtype=np.uint64)[0] >> 1) for k in kids)
    dense = serve.serve(base.smoke_variant(base.get("qwen2.5-3b")), **kw)
    assert dense.modal is None
    assert torch.equal(dense.prompt, torch.randint(
        0, 512, (2, 6), generator=torch.Generator().manual_seed(s_tokens)))
    given = drawn.modal * 0.5
    res = serve.serve(cfg, **kw, modal=given)
    assert res.modal is given
    logits, cache = registry.build(cfg).prefill_step(
        res.params, {"tokens": res.prompt, "modal_embeds": given},
        device="cpu")
    assert torch.equal(res.prefill_logits, logits)
    assert all(torch.equal(res.prefill_cache[k], cache[k]) for k in cache)
    assert not torch.equal(res.prefill_cache["xk"],
                           drawn.prefill_cache["xk"])
    assert tuple(res.tokens.shape) == (2, 3)


# ---------------------------------------------------------------------------
# Checks both families' tests run
# ---------------------------------------------------------------------------
def check_forward(jcfg, cfg, jp, tp, *, seed=5):
    """`forward`'s logits (every impl), its hidden states, and under remat
    its values and gradients, against the reference's forward."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(2, 12))
    modal = modal_input(cfg, 2, seed + 1)
    kw = dict(modal_embeds=jnp.asarray(modal))
    want, jaux = jax.jit(lambda p, t: jT.forward(p, jcfg, t, **kw))(
        jp, jnp.asarray(tokens, jnp.int32))
    jhidden, _ = jax.jit(lambda p, t: jT.forward(
        p, jcfg, t, return_hidden=True, **kw))(jp, jnp.asarray(tokens,
                                                               jnp.int32))
    tok, mod = torch.from_numpy(tokens), torch.from_numpy(modal)
    for impl in ("auto", "torch", "kernel"):
        with torch.no_grad():
            got, aux = transformer.forward(tp, cfg, tok, modal_embeds=mod,
                                           impl=impl)
        assert float(aux) == float(jaux) == 0.0
        np.testing.assert_allclose(np32(got), np32(want), **MODEL_TOL)
    with torch.no_grad():
        hidden, _ = transformer.forward(tp, cfg, tok, modal_embeds=mod,
                                        return_hidden=True)
    np.testing.assert_allclose(np32(hidden), np32(jhidden), **MODEL_TOL)
    # Under remat (checkpointed layers) the values and gradients are the
    # same as without.
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        logits, _ = transformer.forward(leaves, c, tok, modal_embeds=mod,
                                        impl="torch")
        np.testing.assert_allclose(np32(logits), np32(want), **MODEL_TOL)
        loss = logits.square().mean()
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for name, a, b in zip(tp, *grads):
        np.testing.assert_allclose(np32(a), np32(b), **TOL, err_msg=name)


def check_prefill_and_decode(jcfg, cfg, jp, tp, *, window=None, steps=6,
                             seed=3):
    """Prefill logits and every cache leaf (k, v, xk, xv), through the
    plain attention and the kernel's plain version, then ``steps`` greedy
    decode steps against caches grown to prompt + steps (`grow_cache`
    pads k / v only), all under ``window``, against the reference."""
    bundle = registry.build(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(2, 10))
    modal = modal_input(cfg, 2, seed + 1)
    jlogits, jcache = jax.jit(lambda p, t, m: jT.prefill(
        p, jcfg, t, modal_embeds=m, window=window))(
            jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(modal))
    batch = {"tokens": torch.from_numpy(tokens),
             "modal_embeds": torch.from_numpy(modal)}
    for impl in ("torch", "kernel"):
        logits, cache = bundle.prefill_step(tp, batch, impl=impl,
                                            window=window, device="cpu")
        np.testing.assert_allclose(np32(logits), np32(jlogits), **MODEL_TOL)
        assert list(cache) == list(jcache) == ["k", "v", "xk", "xv"]
        for name in cache:
            assert tuple(cache[name].shape) == jcache[name].shape, name
            np.testing.assert_allclose(np32(cache[name]), np32(jcache[name]),
                                       **MODEL_TOL, err_msg=name)
    total = tokens.shape[1] + steps
    grown = serve.grow_cache(cache, total)
    assert grown["xk"] is cache["xk"] and grown["xv"] is cache["xv"]
    cache, jcache = grown, grow_ref(jcache, total)
    jstep = jax.jit(lambda p, c, t, pos: jT.serve_step(p, jcfg, c, t, pos,
                                                       window=window))
    for i in range(steps):
        jtok = jnp.argmax(jlogits.reshape(2, -1), axis=-1)[:, None]
        tok = logits.reshape(2, -1).argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        pos = tokens.shape[1] + i
        jlogits, jcache = jstep(jp, jcache, jtok.astype(jnp.int32),
                                jnp.int32(pos))
        logits, new = bundle.serve_step(tp, cache, tok, pos, window=window,
                                        device="cpu")
        assert list(new) == list(jcache)
        assert all(new[k] is cache[k] for k in cache)   # written in place
        np.testing.assert_allclose(np32(logits), np32(jlogits), **MODEL_TOL)
        for name in new:
            np.testing.assert_allclose(np32(new[name]), np32(jcache[name]),
                                       **MODEL_TOL, err_msg=name)


def check_decode_matches_forward(cfg, tp, *, prompt=4, seed=6):
    """A prefill of ``prompt`` tokens, then decoding the rest one token at a
    time, gives the forward's logits at every position (as the reference's
    family test holds decode to forward)."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 12)))
    modal = torch.from_numpy(modal_input(cfg, 2, seed + 1))
    with torch.no_grad():
        want, _ = transformer.forward(tp, cfg, tokens, modal_embeds=modal)
        logits, cache = transformer.prefill(tp, cfg, tokens[:, :prompt],
                                            modal_embeds=modal)
    np.testing.assert_allclose(np32(logits), np32(want[:, prompt - 1]),
                               **MODEL_TOL)
    cache = serve.grow_cache(cache, tokens.shape[1])
    for i in range(prompt, tokens.shape[1]):
        logits, cache = transformer.serve_step(tp, cfg, cache,
                                               tokens[:, i:i + 1], i)
        np.testing.assert_allclose(np32(logits[:, 0]), np32(want[:, i]),
                                   **MODEL_TOL, err_msg=f"position {i}")


def check_init_cache(jcfg, cfg):
    """`init_cache`'s leaves (names, shapes, dtypes, zeros) against the
    reference's, with and without a window that wraps."""
    for window in (None, 4, 64):
        want = jax.eval_shape(lambda: jT.init_cache(jcfg, 2, 16,
                                                    window=window))
        got = transformer.init_cache(cfg, 2, 16, window=window,
                                     device="cpu")
        assert list(got) == list(want) == ["k", "v", "xk", "xv"]
        for name in got:
            assert tuple(got[name].shape) == want[name].shape, name
            assert got[name].dtype == {"float32": torch.float32,
                                       "bfloat16": torch.bfloat16}[
                jnp.dtype(want[name].dtype).name]
            assert not got[name].any()


def check_loss_and_train_step(jcfg, cfg, jp, tp, prefixes, *, seed=8):
    """`loss_fn`'s value and every leaf's gradient (those under
    ``prefixes`` among them, nonzero) against the reference's, then one
    AdamW `train_step` and the next loss."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(2, 12))
    modal = modal_input(cfg, 2, seed + 1)
    jbundle = jregistry.build(jcfg, lr=1e-3)
    jb = jbatch(jcfg, tokens, modal)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbundle.loss_fn(p, jb), has_aux=True))(jp)
    jgrads = tree(jgrads)
    bundle = registry.build(cfg, lr=1e-3)
    batch = {"tokens": torch.from_numpy(tokens),
             "modal_embeds": torch.from_numpy(modal)}
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    total, metrics = bundle.loss_fn(leaves, batch, device="cpu")
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    assert float(metrics["aux"]) == 0.0
    grads = dict(zip(leaves, torch.autograd.grad(total,
                                                 list(leaves.values()))))
    assert list(grads) == list(jgrads)
    for name in grads:
        np.testing.assert_allclose(np32(grads[name]), np32(jgrads[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    for prefix in prefixes:
        under = [k for k in grads if k.startswith(prefix)]
        # (A key bias shifts every logit of a query alike: no gradient.)
        assert under and all(float(grads[k].abs().max()) > 0 for k in under
                             if not k.endswith(".bk")), prefix
    jstate = {"params": jp, "opt": jbundle.optimizer.init(jp)}
    jstep = jax.jit(jbundle.train_step)
    jstate, jm = jstep(jstate, jb)
    _, jm2 = jstep(jstate, jb)
    params = {k: v.clone() for k, v in tp.items()}
    state = {"params": params, "opt": bundle.optimizer.init(params)}
    state, m = bundle.train_step(state, batch, device="cpu")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    _, m2 = bundle.train_step(state, batch, device="cpu")
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               **MODEL_TOL)


def check_gates(jcfg, cfg, seed=11):
    """With the gates drawn (zero), two modal inputs give logits equal bit
    for bit in both packages: the cross path does not reach them.  With
    the gates set they move, in both, by the same amount."""
    jp0 = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, size=(2, 9))
    modals = [modal_input(cfg, 2, seed + i) for i in (1, 2)]
    for jp, moves in ((jp0, False), (gated(jp0, seed), True)):
        tp = tree(jp)
        outs, jouts = [], []
        for m in modals:
            jouts.append(np32(jT.forward(jp, jcfg, jnp.asarray(tokens),
                                         modal_embeds=jnp.asarray(m))[0]))
            with torch.no_grad():
                outs.append(np32(transformer.forward(
                    tp, cfg, torch.from_numpy(tokens),
                    modal_embeds=torch.from_numpy(m))[0]))
        moved = float(np.abs(outs[0] - outs[1]).max())
        jmoved = float(np.abs(jouts[0] - jouts[1]).max())
        if moves:
            assert moved > 0.05 and jmoved > 0.05
            np.testing.assert_allclose(moved, jmoved, rtol=1e-3)
        else:
            assert moved == jmoved == 0.0


def check_train_main(arch, cfg):
    """`launch.train.main` at the smoke size, plain and ``--dfl``: each
    step's batch carries zero modal embeddings (B, T, D) in the config's
    dtype, as the reference's; the losses are finite."""
    from repro_torch.launch import train

    seen = []
    build = registry.build

    def spy(c, **kw):
        bundle = build(c, **kw)

        def train_step(state, batch, **k):
            seen.append(batch["modal_embeds"])
            return bundle.train_step(state, batch, **k)

        return bundle._replace(train_step=train_step)

    registry.build = spy
    try:
        out = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
        dfl = train.main(["--arch", arch, "--device", "cpu", "--dfl",
                          "--clients", "2", "--steps", "2",
                          "--rounds-per-exchange", "1", "--batch", "2",
                          "--seq", "16"])
    finally:
        registry.build = build
    assert out["cfg"] == cfg
    assert len(out["losses"]) == 2 and len(dfl["round_losses"]) == 2
    assert all(np.isfinite(x) for x in out["losses"] + dfl["losses"])
    assert len(seen) == 2 + 4
    for m in seen:
        assert tuple(m.shape) == (2, transformer.modal_len(cfg), cfg.d_model)
        assert m.dtype == cfg.dtype and not m.any()
