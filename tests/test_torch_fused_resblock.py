"""Parity of the port's single-ResnetBlock op
(diffuscene_tpu_torch/ops/fused_resblock.py) with the JAX package's Pallas
kernel (diffuscene_tpu/ops/fused_resblock.py:fused_resnet_block).

On the CPU the port's ``fused_resnet_block`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode, as its own tests do.  The same
numpy inputs, made from a seed, go to both.  Tolerances: f32 atol 2e-5, the
JAX package's own (tests/test_fused_engine.py:42), for the same f32 math
summed in another order; bf16 atol 5e-2, rtol 2e-2: one rounding of an
output of O(1) is 2^-8 relative, and a flipped rounding of the second
product's operand moves an output by about as much.

The CUDA kernel itself runs only on the card: see ``chip_smoke.py`` and the
``gpu``-marked test at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.ops import fused_resblock as jrb
from diffuscene_tpu_torch.models.denoiser import ResnetBlock, init_parameters
from diffuscene_tpu_torch.ops import fused_resblock as trb

C, GROUPS = 64, 8
TOL = {"f32": dict(atol=2e-5, rtol=0), "bf16": dict(atol=5e-2, rtol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(B, N, c_in, seed=0, c=C):
    """numpy inputs of one block: x (M, c_in), per-row film, weights."""
    rng = np.random.default_rng(seed)
    M = B * N
    f = lambda *s, scale=1.0, base=0.0: (base + rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    d = {"x": f(M, c_in), "film": f(M, 2 * c, scale=0.2),
         "w1": f(c_in, c, scale=c_in ** -0.5), "b1": f(c, scale=0.1),
         "gn1_scale": f(c, scale=0.1, base=1.0), "gn1_bias": f(c, scale=0.1),
         "w2": f(c, c, scale=c ** -0.5), "b2": f(c, scale=0.1),
         "gn2_scale": f(c, scale=0.1, base=1.0), "gn2_bias": f(c, scale=0.1)}
    if c_in != c:
        d["w_res"] = f(c_in, c, scale=c_in ** -0.5)
        d["b_res"] = f(c, scale=0.1)
    return d


_WEIGHTS = ("w1", "b1", "gn1_scale", "gn1_bias", "w2", "b2", "gn2_scale", "gn2_bias")


def _run_jax(d, N, dtype):
    jdt = DTYPES[dtype][0]
    kw = {k: jnp.asarray(d[k]) for k in _WEIGHTS}
    if "w_res" in d:
        kw.update(w_res=jnp.asarray(d["w_res"]), b_res=jnp.asarray(d["b_res"]))
    out = jrb.fused_resnet_block(jnp.asarray(d["x"]).astype(jdt), jnp.asarray(d["film"]),
                                 n_per_scene=N, groups=GROUPS, compute_dtype=jdt, **kw)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(d, N, dtype, film=None, skip_split=None):
    """The port on CPU tensors; ``film`` replaces d["film"]; ``skip_split``
    passes x as two tensors, x[:, :k] and the skip x[:, k:]."""
    tdt = DTYPES[dtype][1]
    kw = {k: torch.from_numpy(d[k]) for k in _WEIGHTS}
    if "w_res" in d:
        kw.update(w_res=torch.from_numpy(d["w_res"]), b_res=torch.from_numpy(d["b_res"]))
    x = torch.from_numpy(d["x"]).to(tdt)
    skip = None
    if skip_split is not None:
        x, skip = x[:, :skip_split].contiguous(), x[:, skip_split:].contiguous()
    film = torch.from_numpy(d["film"]) if film is None else film
    out = trb.fused_resnet_block(x, film, n_per_scene=N, groups=GROUPS, compute_dtype=tdt,
                                 skip=skip, **kw)
    assert out.dtype == tdt and out.shape == (d["x"].shape[0], C)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c_in", [C, 2 * C])
@pytest.mark.parametrize("N", [12, 21])
def test_block_matches_jax_pallas(N, c_in, dtype):
    """C_in = C: identity residual; C_in = 2C: the skip-concat shape, with
    its residual projection."""
    d = _case(2, N, c_in, seed=N + c_in)
    np.testing.assert_allclose(_run_torch(d, N, dtype), _run_jax(d, N, dtype), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_per_scene_film_and_skip_forms_match_jax(dtype):
    """The engine's forms: a per-scene (B, 2C) film and a skip-concat input
    as two tensors equal B1 on the expanded rows and the concatenation."""
    B, N = 2, 12
    d = _case(B, N, 2 * C, seed=3)
    scene_film = d["film"][::N].copy()                      # (B, 2C)
    d["film"] = np.repeat(scene_film, N, axis=0)            # B1's own per-row form
    want = _run_jax(d, N, dtype)
    got = _run_torch(d, N, dtype, film=torch.from_numpy(scene_film), skip_split=C)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    # and in the port the two forms are the same computation
    assert np.array_equal(got, _run_torch(d, N, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_no_film_equals_zero_film_rows(dtype):
    """A FiLM-free block (film None) is B1 with zero film rows, exactly."""
    d = _case(2, 12, C, seed=4)
    tdt = DTYPES[dtype][1]
    w = [torch.from_numpy(d[k]) for k in _WEIGHTS]
    x = torch.from_numpy(d["x"]).to(tdt)
    none = trb.fused_resnet_block(x, None, *w, n_per_scene=12, compute_dtype=tdt)
    zero = trb.fused_resnet_block(x, torch.zeros(24, 2 * C), *w, n_per_scene=12,
                                  compute_dtype=tdt)
    assert torch.equal(none, zero)
    d["film"] = np.zeros_like(d["film"])
    np.testing.assert_allclose(none.float().numpy(), _run_jax(d, 12, dtype), **TOL[dtype])


@pytest.mark.parametrize("c_in", [C, 2 * C])
def test_block_matches_module_resnet_block_f32(c_in):
    """The op on the module's prepared weights equals the port's
    ``ResnetBlock`` (per-object condition rows through its mlp) in f32."""
    B, N, E = 2, 12, 48
    block = ResnetBlock(c_in, C, emb_dim=E, groups=GROUPS)
    init_parameters(block, torch.Generator().manual_seed(c_in))
    with torch.no_grad():
        for name, p in block.named_parameters():   # every leaf non-trivial
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    rng = np.random.default_rng(c_in)
    x = torch.from_numpy(rng.normal(size=(B, N, c_in)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(B, N, E)).astype(np.float32))
    with torch.no_grad():
        want = block(x, emb).reshape(B * N, C)
        film = block.mlp(emb).reshape(B * N, 2 * C)
        b1, b2 = block.block1, block.block2
        got = trb.fused_resnet_block(
            x.reshape(B * N, c_in), film,
            trb.standardize_kernel(b1.proj.kernel()), b1.proj.bias, b1.norm.weight, b1.norm.bias,
            trb.standardize_kernel(b2.proj.kernel()), b2.proj.bias, b2.norm.weight, b2.norm.bias,
            w_res=None if block.res_conv is None else block.res_conv.kernel(),
            b_res=None if block.res_conv is None else block.res_conv.bias,
            n_per_scene=N, groups=GROUPS, compute_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_wrapper_validates_and_counts_only_kernel_launches():
    d = _case(2, 12, 2 * C, seed=5)
    before = trb.fused_resnet_block.launches
    _run_torch(d, 12, "f32")
    assert trb.fused_resnet_block.launches == before  # the CPU path is not a launch
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    w = [t[k] for k in _WEIGHTS]
    with pytest.raises(ValueError):   # rows that are not whole scenes
        trb.fused_resnet_block(t["x"][:-1], None, *w, w_res=t["w_res"], n_per_scene=12)
    with pytest.raises(ValueError):   # an identity residual over a wider input
        trb.fused_resnet_block(t["x"], None, *w, n_per_scene=12)
    with pytest.raises(ValueError):   # a film of neither rows nor scenes
        trb.fused_resnet_block(t["x"], t["film"][:5], *w, w_res=t["w_res"], n_per_scene=12)
    with pytest.raises(ValueError):   # neither cpu nor cuda: no silent fallback
        trb.fused_resnet_block(t["x"].to("meta"), None, *w, w_res=t["w_res"], n_per_scene=12)


def test_prepared_operands_follow_their_weights():
    """The wrappers pack and stack weights once per weight set
    (ops/build.py:prepared): the same tensors give the same operands; an
    in-place change of any of them, or another tensor, makes them anew."""
    from diffuscene_tpu_torch.ops import build

    b, w = torch.zeros(4), torch.ones(4, 4)
    made = []

    def make():
        made.append(w.sum().item())
        return len(made)

    assert build.prepared(b, (w, None), make) == 1
    assert build.prepared(b, (w, None), make) == 1
    w.add_(1.0)                                # in place
    assert build.prepared(b, (w, None), make) == 2
    assert build.prepared(b, (w.clone(), None), make) == 3   # another tensor
    assert made == [16.0, 32.0, 32.0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c_in,film", [(512, "row"), (512, "none"), (1024, "scene")])
def test_cuda_kernel_matches_plain_version(c_in, film, dtype):
    """The CUDA kernel against its plain version on the card, C=512, a
    ragged last tile (7 scenes of 12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    B, N = 7, 12
    d = _case(B, N, c_in, seed=6, c=512)
    tdt = DTYPES[dtype][1]
    dev = torch.device("cuda")
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    f = {"row": t["film"], "scene": t["film"][::N].contiguous(), "none": None}[film]
    kw = dict(w_res=t.get("w_res"), b_res=t.get("b_res"), n_per_scene=N, compute_dtype=tdt)
    x = t["x"].to(tdt)
    skip = None
    if c_in == 1024:
        x, skip = x[:, :512].contiguous(), x[:, 512:].contiguous()
    args = (x, f, *(t[k] for k in _WEIGHTS))
    got = trb.fused_resnet_block(*args, skip=skip, **kw)
    want = trb.fused_resnet_block_reference(*args, skip=skip, **kw)
    torch.cuda.synchronize()
    tol = dict(atol=1e-3, rtol=1e-4) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
