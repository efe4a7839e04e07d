"""PyTorch port vs the JAX reference: the serving entry point.

`repro_torch.launch.serve.serve` on the smoke rwkv6 and the smoke qwen2.5
against the loop of the reference's `repro.launch.serve.main` (prefill,
grow the attention caches, then greedy `serve_step`s), with the reference's
weights (through `interop`) and the same prompt ids.  In float32 the
generated ids must be equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
from repro.configs import base as jbase  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def _reference_loop(cfg, params, tokens, gen):
    """`repro.launch.serve.main`'s prefill + decode loop (serve.py:54-89),
    attention caches grown to prompt + gen as it grows them."""
    bundle = jregistry.build(cfg)
    prefill = jax.jit(lambda p, bt: bundle.prefill_step(p, bt))
    logits, cache = prefill(params, {"tokens": tokens})
    s = tokens.shape[1]
    for name in ("k", "v"):
        if name in cache:
            pad = [(0, 0)] * cache[name].ndim
            pad[-3] = (0, s + gen - cache[name].shape[-3])
            cache[name] = jnp.pad(cache[name], pad)
    step = jax.jit(lambda p, c, t, pos: bundle.serve_step(p, c, t, pos))
    tok = jserve.first_token(logits)
    generated = [tok]
    for i in range(gen - 1):
        logits, cache = step(params, cache, tok, jnp.int32(s + i))
        tok = jserve.first_token(logits)
        generated.append(tok)
    return np.asarray(jnp.concatenate(generated, axis=1))


@pytest.mark.parametrize("batch,prompt_len,gen", [(4, 32, 16), (2, 96, 12)])
def test_serve_matches_reference_loop(batch, prompt_len, gen):
    jcfg = jbase.smoke_variant(jbase.get("rwkv6-1.6b"))
    cfg = base.smoke_variant(base.get("rwkv6-1.6b"))
    k_params, k_tokens, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    jparams = jregistry.build(jcfg).init(k_params)
    jtokens = jax.random.randint(k_tokens, (batch, prompt_len), 0, jcfg.vocab)
    want = _reference_loop(jcfg, jparams, jtokens, gen)

    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = torch.from_numpy(np.asarray(jtokens, np.int64))
    res = serve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                      device="cpu", params=params, tokens=tokens)
    assert tuple(res.tokens.shape) == (batch, gen)
    assert np.array_equal(res.tokens.numpy(), want)
    assert res.decode_steps == gen - 1
    assert res.prefill_s > 0 and res.decode_s > 0
    assert tuple(res.prefill_logits.shape) == (batch, cfg.vocab)


def test_serve_draws_from_its_seed():
    cfg = base.smoke_variant(base.get("rwkv6-1.6b"))
    a, b, c = (serve.serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu",
                           seed=s) for s in (0, 0, 1))
    assert torch.equal(a.prompt, b.prompt) and torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.prompt, c.prompt)
    assert int(a.prompt.max()) < cfg.vocab and int(a.prompt.min()) >= 0
    with pytest.raises(ValueError, match="gen must be at least 1"):
        serve.serve(cfg, batch=1, prompt_len=4, gen=0, device="cpu")


def test_main_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: batch=2 len=8" in out
    assert "decode: 3 steps x batch 2" in out
    ids = out.split("sample token ids:")[1].strip()
    assert len(ids.strip("[]").split(",")) == 4


def test_serve_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = base.smoke_variant(base.get("rwkv6-1.6b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve(cfg, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])


@pytest.mark.parametrize("batch,prompt_len,gen", [(4, 32, 16), (2, 96, 12)])
def test_serve_qwen_matches_reference_loop(batch, prompt_len, gen):
    """The dense family: the smoke qwen2.5 (float32, 2 layers, 4 heads, one
    kv head of 64), its QKV biases drawn so that they count."""
    jcfg = jbase.smoke_variant(jbase.get("qwen2.5-3b"))
    cfg = base.smoke_variant(base.get("qwen2.5-3b"))
    k_params, k_tokens, k_bias = jax.random.split(jax.random.PRNGKey(0), 3)
    jparams = jregistry.build(jcfg).init(k_params)
    attn = jparams["layers"]["attn"]
    for i, name in enumerate(("bq", "bk", "bv")):
        attn[name] = 0.3 * jax.random.normal(jax.random.fold_in(k_bias, i),
                                             attn[name].shape)
    jtokens = jax.random.randint(k_tokens, (batch, prompt_len), 0, jcfg.vocab)
    want = _reference_loop(jcfg, jparams, jtokens, gen)

    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = torch.from_numpy(np.asarray(jtokens, np.int64))
    res = serve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                      device="cpu", params=params, tokens=tokens)
    assert np.array_equal(res.tokens.numpy(), want)
    assert tuple(res.prefill_cache["k"].shape) == (2, batch, prompt_len, 1, 64)
    # On the CPU no kernel launches, in either phase.
    assert set(res.prefill_launches.values()) == {0}
    assert set(res.decode_launches.values()) == {0}


def test_main_serves_the_dense_smoke_model(capsys):
    serve.main(["--arch", "qwen2.5-3b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: batch=2 len=8" in out
    assert "decode: 3 steps x batch 2" in out


def test_grow_cache_pads_attention_caches_only():
    k = torch.ones(2, 3, 5, 1, 4)
    state = torch.ones(2, 3, 4, 4)
    grown = serve.grow_cache({"k": k, "v": 2 * k, "rwkv_state": state}, 9)
    assert tuple(grown["k"].shape) == (2, 3, 9, 1, 4)
    assert torch.equal(grown["v"][:, :, :5], 2 * k)
    assert not grown["k"][:, :, 5:].any()
    assert grown["rwkv_state"] is state
