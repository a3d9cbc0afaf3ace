"""The port's KV-cache decode path (``models/transformer.py``: ``_prefill``,
``prefill_request``, ``generate``, ``decode_step``) against the JAX
package's, on the CPU.

Two models: ``tests/test_serving.py``'s serving model (``SERVE``), and a
wider one (``WIDE``, width 128, three layers).  Weights come from the JAX
package's ``init`` through ``models/convert.py``; prompts from numpy seeds.
The fp32 greedy-token test also runs WIDE with its matrices times 5, so that
greedy decoding changes token from step to step (at the init's std 0.02 a
few-layer model repeats its last token); such weights amplify rounding
differences chaotically, so the element-wise comparisons keep the init's.

Tolerances, relative to the largest element of the JAX result:

* fp32: ``F32_TOL`` 1e-5.  Both sides compute in fp32 and differ only in
  the order of their sums (read: ≤ 3e-7).
* bf16: ``BF16_TOL`` 2**-6, four bf16 ulps (2**-8 relative) of the largest
  element.  Each side rounds every product to bf16 after accumulating it in
  fp32 in its own order, so single elements land one ulp apart and the
  differences carry through the layers (read: logits ≤ 2.4e-3, K/V
  ≤ 7.1e-3).

Greedy tokens must be equal in fp32.  In bf16 they must be equal up to the
first step whose top-2 logit margin on the JAX side is within the bf16
tolerance; a divergence anywhere else fails.
"""

import functools

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm

SERVE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64)
WIDE = dict(vocab_size=256, d_model=128, n_layers=3, n_heads=4, d_ff=256)
MODELS = {"serve": (SERVE, 1.0), "wide": (WIDE, 5.0)}
CACHE_LEN = 64
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6

CASES = [("serve", "float32"), ("wide", "float32"), ("serve", "bfloat16"),
         ("wide", "bfloat16")]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert gap <= tol, f"{what}: {gap:.3e} of max|ref| > {tol:.3e}"


def _jax_cfg(name, dtype):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    return jtfm.TransformerConfig(max_seq_len=CACHE_LEN, remat=False,
                                  compute_dtype=getattr(jnp, dtype),
                                  **MODELS[name][0])


@functools.lru_cache(maxsize=None)
def _params(name, dtype, scaled=False):
    """The JAX init's weights as numpy; ``scaled``: the matrices times the
    model's scale."""
    import jax

    from horovod_tpu.models import transformer as jtfm

    params = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0),
                                                _jax_cfg(name, dtype)))
    scale = MODELS[name][1] if scaled else 1.0
    return jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a, params)


def _port_model(name, dtype, scaled=False):
    cfg = tfm.TransformerConfig(max_seq_len=CACHE_LEN, remat=False,
                                compute_dtype=getattr(torch, dtype),
                                **MODELS[name][0])
    model = tfm.Transformer(cfg)
    model.load_state_dict(convert.params_from_jax(
        _params(name, dtype, scaled)))
    return model


def _jparams(name, dtype, scaled=False):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, _params(name, dtype, scaled))


def _prompt(name, seed, n):
    vocab = MODELS[name][0]["vocab_size"]
    return np.random.RandomState(seed).randint(0, vocab, n).astype(np.int32)


def _f32(x):
    return np.asarray(x).astype(np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("name,dtype", CASES)
def test_prefill_matches_jax(name, dtype):
    """``prefill_request``'s logits and K/V caches, and ``_prefill`` at a
    batch of two, against the JAX package's."""
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    cfg, jp, model = _jax_cfg(name, dtype), _jparams(name, dtype), \
        _port_model(name, dtype)
    tol = _tol(dtype)
    for seed, n in ((0, 5), (1, 23)):
        prompt = _prompt(name, seed, n)
        jl, jks, jvs = jtfm.prefill_request(jp, jnp.asarray(prompt), cfg,
                                            CACHE_LEN)
        with torch.inference_mode():
            tl, tks, tvs = tfm.prefill_request(model, torch.tensor(prompt),
                                               CACHE_LEN)
        assert tl.dtype == torch.float32 and tks.dtype == getattr(torch,
                                                                  dtype)
        assert tuple(tks.shape) == (cfg.n_layers, 1, CACHE_LEN,
                                    cfg.n_heads, cfg.head_dim)
        _close(tl, _f32(jl), tol, f"logits, prompt {n}")
        _close(_f32(tks), _f32(jks), tol, f"K cache, prompt {n}")
        _close(_f32(tvs), _f32(jvs), tol, f"V cache, prompt {n}")
        assert not tks[:, :, n:].any()  # zero past the prompt
    batch = np.stack([_prompt(name, 2, 9), _prompt(name, 3, 9)])
    jl, jks, _ = jtfm._prefill(jp, jnp.asarray(batch), cfg, CACHE_LEN)
    with torch.inference_mode():
        tl, tks, _ = tfm._prefill(model, torch.tensor(batch), CACHE_LEN)
    _close(tl, _f32(jl), tol, "batched logits")
    _close(_f32(tks), _f32(jks), tol, "batched K cache")


def _jax_decode_logits(name, dtype, prompt, tokens):
    """JAX's next-token logits at each step of decoding ``prompt`` fed
    ``tokens`` (prefill_request, then decode_step at one slot)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    cfg, jp = _jax_cfg(name, dtype), _jparams(name, dtype)
    logits, ks, vs = jtfm.prefill_request(jp, jnp.asarray(prompt), cfg,
                                          CACHE_LEN)
    step = jax.jit(functools.partial(jtfm.decode_step, cfg=cfg))
    out = [np.asarray(logits)]
    for i, tok in enumerate(tokens[:-1]):
        lg, ks, vs = step(jp, jnp.asarray([tok], jnp.int32),
                          jnp.asarray([len(prompt) + i], jnp.int32), ks, vs)
        out.append(np.asarray(lg)[0])
    return np.stack(out)


@pytest.mark.parametrize("name,dtype", CASES)
def test_generate_greedy_matches_jax(name, dtype):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    scaled = dtype == "float32"
    cfg, jp, model = _jax_cfg(name, dtype), _jparams(name, dtype, scaled), \
        _port_model(name, dtype, scaled)
    new = 12
    for seed, n in ((4, 6), (5, 17)):
        prompt = _prompt(name, seed, n)
        want = np.asarray(jtfm.generate(
            jp, jnp.asarray(prompt[None]), cfg, max_new_tokens=new,
            cache_len=CACHE_LEN))[0, n:]
        got = tfm.generate(model, prompt[None], max_new_tokens=new,
                           cache_len=CACHE_LEN, device="cpu")
        assert got.shape == (1, n + new)
        assert got[0, :n].tolist() == prompt.tolist()
        got = got[0, n:].numpy()
        if dtype == "float32":
            assert got.tolist() == want.tolist()
            if name == "wide":
                assert len(set(want.tolist())) > new // 2  # tokens vary
            continue
        diff = np.flatnonzero(got != want)
        if diff.size:
            i = int(diff[0])
            logits = _jax_decode_logits(name, dtype, prompt, want)
            top = np.sort(logits[i])[::-1]
            assert top[0] - top[1] <= BF16_TOL * np.abs(logits[i]).max(), (
                f"bf16 tokens diverge at step {i} with margin "
                f"{top[0] - top[1]:.3e}")


@pytest.mark.parametrize("name,dtype", CASES)
def test_decode_step_ragged_matches_jax(name, dtype):
    """Three slots at positions 4, 11 and 30 (each prefilled from its own
    prompt), four steps of ``decode_step``: the logits and both caches
    against the JAX package's after every step."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    cfg, jp, model = _jax_cfg(name, dtype), _jparams(name, dtype), \
        _port_model(name, dtype)
    tol = _tol(dtype)
    lens = (4, 11, 30)
    jks, jvs, tks, tvs, toks = [], [], [], [], []
    for slot, n in enumerate(lens):
        prompt = _prompt(name, 10 + slot, n)
        jl, k, v = jtfm.prefill_request(jp, jnp.asarray(prompt), cfg,
                                        CACHE_LEN)
        jks.append(k)
        jvs.append(v)
        with torch.inference_mode():
            _, k, v = tfm.prefill_request(model, torch.tensor(prompt),
                                          CACHE_LEN)
        tks.append(k)
        tvs.append(v)
        toks.append(int(np.argmax(np.asarray(jl))))
    jks, jvs = jnp.concatenate(jks, 1), jnp.concatenate(jvs, 1)
    tks, tvs = torch.cat(tks, 1), torch.cat(tvs, 1)
    tok = np.asarray(toks, np.int32)
    pos = np.asarray(lens, np.int32)
    step = jax.jit(functools.partial(jtfm.decode_step, cfg=cfg))
    for i in range(4):
        jl, jks, jvs = step(jp, jnp.asarray(tok), jnp.asarray(pos), jks, jvs)
        tl, tks2, tvs2 = tfm.decode_step(model, torch.tensor(tok).long(),
                                         torch.tensor(pos).long(), tks, tvs)
        assert tks2 is tks and tvs2 is tvs  # written in place
        _close(tl, _f32(jl), tol, f"logits, step {i}")
        _close(_f32(tks), _f32(jks), tol, f"K cache, step {i}")
        _close(_f32(tvs), _f32(jvs), tol, f"V cache, step {i}")
        tok = np.asarray(np.argmax(np.asarray(jl), -1), np.int32)
        pos = pos + 1


def test_rope_rows_is_scalar_rope_row_by_row():
    x = torch.randn(3, 1, 2, 16, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([0, 7, 63])
    got = tfm._rope_rows(x, 10000.0, pos)
    for b, p in enumerate(pos.tolist()):
        assert torch.equal(got[b], tfm._rope(x[b:b + 1], 10000.0, p)[0])


def test_decode_weights_cast_the_matrices_once():
    model = _port_model("serve", "float32")
    model.cfg = tfm.TransformerConfig(**{**model.cfg.__dict__,
                                         "compute_dtype": torch.bfloat16})
    w = tfm.decode_weights(model, torch.device("cpu"))
    assert w.embed.dtype == torch.bfloat16 and w.ln_f.dtype == torch.float32
    blk = w.layers[1]
    assert blk.wq.dtype == blk.w_out.dtype == torch.bfloat16
    assert blk.ln1.dtype == blk.ln2.dtype == torch.float32
    assert torch.equal(blk.wo, model.layers[1].wo.to(torch.bfloat16))
    prompt = torch.tensor(_prompt("serve", 0, 7))
    with torch.inference_mode():
        a = tfm.prefill_request(model, prompt, CACHE_LEN)
        b = tfm.prefill_request(w, prompt, CACHE_LEN)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sampling_follows_the_generator():
    model = _port_model("wide", "float32")
    prompt = _prompt("wide", 0, 5)[None]

    def sample(seed):
        return tfm.generate(model, prompt, max_new_tokens=8, temperature=1.5,
                            generator=torch.Generator().manual_seed(seed),
                            cache_len=CACHE_LEN, device="cpu")

    a, b, c = sample(0), sample(0), sample(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (1, 13) and int(a.max()) < WIDE["vocab_size"]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(temperature=0.5), ValueError, "temperature sampling needs"),
    (dict(max_new_tokens=0), ValueError, "max_new_tokens must be >= 1"),
    (dict(max_new_tokens=60), ValueError, r"exceeds max_seq_len \(64\)"),
    (dict(cache_len=8), ValueError, r"cache_len \(8\) is shorter"),
], ids=["no-generator", "max-new", "max-seq-len", "cache-len"])
def test_generate_errors(kw, exc, match):
    model = _port_model("serve", "float32")
    args = dict(max_new_tokens=4, device="cpu")
    with pytest.raises(exc, match=match):
        tfm.generate(model, _prompt("serve", 0, 5)[None], **{**args, **kw})


def test_moe_decode_is_not_implemented():
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16, n_experts=2)
    model = tfm.init(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-FFN"):
        tfm.generate(model, [[1, 2]], max_new_tokens=2, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-FFN"):
        tfm.prefill_request(model, torch.tensor([1, 2]), 8)
