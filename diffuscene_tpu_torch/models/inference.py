"""Serving engines for the sampling loop: the denoiser forward with everything
step-invariant prepared once.

Port of ``diffuscene_tpu/models/inference.py``.  Sampling reruns the Unet1D
forward once per step, so everything that does not depend on the current
sample is prepared once per sampling call:

- every WSDense kernel is standardized and cast to the compute dtype once;
- the per-ResnetBlock time-FiLM rows ``mlp(silu(t_emb(t)))`` depend only on
  the integer timestep, so they are tabulated for all T steps as (T, 2C)
  tables and gathered per step;
- the cond-FiLM rows (from the per-object condition) are computed once;
- a text model's 9 cross-attention contexts (softmaxed keys times values,
  from the text tokens) are computed once, as block-diagonal
  (B, H*D, H*D) matrices (:func:`precompute_conditioning`); each step's
  cross-attention is then its queries against them.

Two forwards share that preparation:

- :func:`fused_unet1d_forward`, the 3-D engine (``fused=True``, the JAX
  package's usual serving configuration): each of the 28 ResnetBlocks is one
  ``ops/fused_resblock.fused_resnet_block`` call (kernel B1 on the card) and
  the middle full attention with its pre-norm and residual is one
  ``ops/attention.fused_set_attention`` call (kernel B2);
- :func:`fused_unet1d_forward_rows`, the rows engine (``fused="rows"``): the
  ResnetBlocks are stacked into 19 chains of 1-2 blocks
  (:func:`prepare_chain_params`) that ``ops/fused_level.apply_chain`` runs
  (kernel B4).

On the H100 (B, N, C) -> (B*N, C) is a view, so both keep activations as
flat (B*N, C) rows; attention views its narrow (M, H*D) head tensors as
(B, N, H*D) for the per-scene contractions.

Parameters come in the Flax tree layout ((in, out) kernels), from
``utils/convert.denoiser_tree``.  The cross-attention blocks fall between
two chains of the rows engine (``downA``/``upA`` end at block1,
``downB``/``upB`` begin at block2), so the chains are the same with text.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import attention as _attention
from ..ops import fused_level as _level
from ..ops import fused_resblock as _resblock
from ..ops.attention import fused_set_attention
from ..ops.fused_level import ChainBlock, apply_chain, build_chain
from ..ops.fused_resblock import fused_resnet_block, standardize_kernel
from .denoiser import Unet1D, head_blockmask, seg_softmax_heads, sinusoidal_pos_emb

# ---------------------------------------------------------------------------
# preparation: everything that is constant across sampling steps
# ---------------------------------------------------------------------------


def _cast(p, dtype):
    if isinstance(p, dict):
        return {k: _cast(v, dtype) for k, v in p.items()}
    return p.to(dtype)


def _std_block(p: Dict[str, Any], eps: float, dtype) -> Dict[str, Any]:
    """Standardize a Block's WSDense kernel (f32) and cast it to the compute
    dtype; GroupNorm scale/bias stay f32."""
    proj = {
        "kernel": standardize_kernel(p["proj"]["kernel"].float(), eps=eps).to(dtype),
        "bias": p["proj"]["bias"].to(dtype),
    }
    return {"proj": proj, "norm": p["norm"]}


def _prep_res(p: Dict[str, Any], ws_eps: float, dtype) -> Dict[str, Any]:
    q = {
        "block1": _std_block(p["block1"], ws_eps, dtype),
        "block2": _std_block(p["block2"], ws_eps, dtype),
    }
    if "res_conv" in p:
        q["res_conv"] = _cast(p["res_conv"], dtype)
    return q


def _time_block_names(n_levels: int):
    names = []
    for i in range(n_levels):
        names += [f"down{i}_block1", f"down{i}_block2"]
    names += ["mid_block1", "mid_block2"]
    for j in range(n_levels):
        names += [f"up{j}_block1", f"up{j}_block2"]
    names += ["final_res_block"]
    return names


def _cond_block_names(n_levels: int):
    names = [f"down{i}_block0" for i in range(n_levels)]
    names += ["mid_block0"]
    names += [f"up{j}_block0" for j in range(n_levels)]
    return names


@torch.no_grad()
def prepare_inference_params(
    net: Unet1D,
    denoiser_params: Dict[str, Any],
    num_timesteps: int,
) -> Dict[str, Any]:
    """Build the serving parameter tree from a Flax-layout ``Unet1D`` tree.

    ``num_timesteps`` must equal the sampling schedule's length: the FiLM
    tables hold one row per integer timestep (hence no default)."""
    dt = net.compute_dtype
    p = denoiser_params
    n_levels = len(net.dim_mults)
    # WSDense picks its standardization eps by activation dtype
    ws_eps = 1e-5 if dt == torch.float32 else 1e-3
    device = p["init_conv"]["kernel"].device

    prep: Dict[str, Any] = {"blocks": {}, "film_t": {}, "misc": {}}

    # time embedding table for all T steps; this MLP uses exact GELU
    ts = torch.arange(num_timesteps, device=device)
    if "sinu_pos_emb" in p:                     # learned / random Fourier features
        tf = ts.float()[:, None]
        freqs = tf * p["sinu_pos_emb"]["weights"][None, :] * 2 * math.pi
        t_feat = torch.cat([tf, torch.sin(freqs), torch.cos(freqs)], dim=-1).to(dt)
    else:
        t_feat = sinusoidal_pos_emb(ts, net.dim).to(dt)
    t_emb = t_feat @ p["time_mlp_1"]["kernel"].to(dt) + p["time_mlp_1"]["bias"].to(dt)
    t_emb = F.gelu(t_emb, approximate="none")
    t_emb = t_emb @ p["time_mlp_2"]["kernel"].to(dt) + p["time_mlp_2"]["bias"].to(dt)
    t_act = F.silu(t_emb)  # (T, time_dim)

    for name in _time_block_names(n_levels):
        blk = p[name]
        prep["blocks"][name] = _prep_res(blk, ws_eps, dt)
        # (T, 2C) FiLM table: mlp(silu(t_emb)) for every integer timestep
        prep["film_t"][name] = (
            t_act @ blk["mlp"]["kernel"].to(dt) + blk["mlp"]["bias"].to(dt)
        ).contiguous()

    for name in _cond_block_names(n_levels):
        blk = p[name]
        prep["blocks"][name] = _prep_res(blk, ws_eps, dt)
        if "mlp" in blk:  # absent when cond_dim == 0
            prep["blocks"][name]["mlp"] = _cast(blk["mlp"], dt)

    for name in list(p.keys()):
        if name in prep["blocks"] or name in ("time_mlp_1", "time_mlp_2", "sinu_pos_emb"):
            continue
        if name.endswith(("_attn_norm", "_attncross_norm")):
            prep["misc"][name] = p[name]  # LayerNorm g stays f32
        else:
            prep["misc"][name] = _cast(p[name], dt)

    if net.seperate_all:
        # every decoder MLP reads the same final feature: one fc0 matmul
        dec = ["bbox_hidden2output", "class_hidden2output"]
        if net.objectness_dim > 0:
            dec.append("objectness_hidden2output")
        if net.objfeat_dim > 0:
            dec.append("objfeat_hidden2output")
        prep["dec_names"] = tuple(dec)
        prep["dec_fc0"] = {
            "kernel": torch.cat([prep["misc"][n]["fc0"]["kernel"] for n in dec], dim=1),
            "bias": torch.cat([prep["misc"][n]["fc0"]["bias"] for n in dec], dim=0),
        }
    return prep


def _cross_names(n_levels: int):
    names = [f"down{i}_attncross" for i in range(n_levels)]
    names += ["mid_attncross"]
    names += [f"up{j}_attncross" for j in range(n_levels)]
    return names


@torch.no_grad()
def precompute_conditioning(
    net: Unet1D,
    prep: Dict[str, Any],
    condition: Optional[torch.Tensor],              # (B, N, cond_dim)
    condition_cross: Optional[torch.Tensor] = None,  # (B, L, text_dim)
) -> Dict[str, Any]:
    """Per-sampling-call cond-FiLM rows {name: (B, N, 2C)} and, for a text
    model, its cross-attention contexts {name: (B, H*D, H*D)}."""
    dt = net.compute_dtype
    n_levels = len(net.dim_mults)
    ctx: Dict[str, Any] = {"film_c": {}, "cross": {}}
    if condition is not None:
        c_act = F.silu(condition.to(dt))
        for name in _cond_block_names(n_levels):
            mlp = prep["blocks"][name].get("mlp")
            if mlp is None:
                continue
            ctx["film_c"][name] = c_act @ mlp["kernel"] + mlp["bias"]
    if net.text_condition:
        cc = condition_cross.to(dt)
        for name in _cross_names(n_levels):
            ctx["cross"][name] = cross_context(prep["misc"][name], cc)
    return ctx


def cross_context(p, cc, heads=4, dim_head=32):
    """The step-invariant half of a linear cross-attention block: the keys
    softmaxed over the text tokens (pads included) times the values, as the
    block-diagonal (B, H*D, H*D) context matrix.  ``cross_context.calls``
    counts the contexts made (9 a sampling call of a text model)."""
    k, v = (cc @ p["to_kv"]["kernel"]).chunk(2, dim=-1)   # (B, L, H*D)
    ctx = torch.einsum("blx,bly->bxy", torch.softmax(k, dim=1), v)
    cross_context.calls += 1
    return ctx * head_blockmask(heads, dim_head, ctx.dtype, ctx.device)


cross_context.calls = 0


# ---------------------------------------------------------------------------
# per-step ops
# ---------------------------------------------------------------------------

def _dense(p, x):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _mlp3(p, x, exact_gelu=False):
    """Encoder/decoder MLP (denoise_net.py:484-504).  Serving defaults to the
    tanh GELU, as the JAX engine does; ``exact_gelu=True`` for parity with
    the module forward."""
    approx = "none" if exact_gelu else "tanh"
    h = F.gelu(_dense(p["fc0"], x), approximate=approx)
    h = F.gelu(_dense(p["fc1"], h), approximate=approx)
    return _dense(p["fc2"], h)


def _channel_layernorm(g, x, dt):
    eps = 1e-5 if x.dtype == torch.float32 else 1e-3
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var + eps)
    a = inv.to(dt)
    b = (-mean * inv).to(dt)
    return (x.to(dt) * a + b) * g.to(dt)


def _wd_from_engine_block(bp: Dict[str, Any], C: int, has_skip: bool) -> Dict[str, Any]:
    """A prepared resblock -> build_chain's weight dict, splitting the (2C, C)
    kernels of skip-concat blocks into their h / skip halves."""
    k1 = bp["block1"]["proj"]["kernel"]
    wd = {
        "b1": bp["block1"]["proj"]["bias"],
        "gn1_scale": bp["block1"]["norm"]["scale"],
        "gn1_bias": bp["block1"]["norm"]["bias"],
        "w2": bp["block2"]["proj"]["kernel"],
        "b2": bp["block2"]["proj"]["bias"],
        "gn2_scale": bp["block2"]["norm"]["scale"],
        "gn2_bias": bp["block2"]["norm"]["bias"],
    }
    if has_skip:
        wd["w1"], wd["w1s"] = k1[:C], k1[C:]
    else:
        wd["w1"] = k1
    if "res_conv" in bp:
        kr = bp["res_conv"]["kernel"]
        wd["bres"] = bp["res_conv"]["bias"]
        if has_skip:
            wd["wres"], wd["wres_s"] = kr[:C], kr[C:]
        else:
            wd["wres"] = kr
    return wd


@torch.no_grad()
def prepare_chain_params(net: Unet1D, prep: Dict[str, Any],
                         cond_names: frozenset) -> Dict[str, Any]:
    """Stack the weights of the 19 resblock chains (once per sampling call).
    ``cond_names`` lists the block0 names that get cond-FiLM rows.  Raises
    ``ValueError`` for unequal level dims, which the chains do not cover
    (``SceneDiffusion.sample(fused="rows")`` then serves the 3-D engine, as
    the JAX package does)."""
    if len(set(net.dim_mults)) != 1:
        raise ValueError("rows-layout chains need equal level dims")
    C = net.dim * net.dim_mults[0]
    n_levels = len(net.dim_mults)
    dt = net.compute_dtype

    def blk(name, film, has_skip=False):
        bp = prep["blocks"][name]
        if has_skip and "res_conv" not in bp:
            raise ValueError(f"{name}: skip-concat block without res_conv")
        spec = ChainBlock(has_skip=has_skip, film=film, has_res_proj="res_conv" in bp)
        return spec, _wd_from_engine_block(bp, C, has_skip), name

    def chain(parts):
        specs = [p[0] for p in parts]
        return {
            "chain": build_chain(specs, [p[1] for p in parts], compute_dtype=dt),
            "films": tuple((spec.film, name) for spec, _, name in parts),
            "skips": tuple(s.has_skip for s in specs),
        }

    def c0film(name):
        return "row" if name in cond_names else "none"

    chains: Dict[str, Any] = {}
    for i in range(n_levels):
        chains[f"downA{i}"] = chain([
            blk(f"down{i}_block0", c0film(f"down{i}_block0")),
            blk(f"down{i}_block1", "scene"),
        ])
        chains[f"downB{i}"] = chain([blk(f"down{i}_block2", "scene")])
    chains["midA"] = chain([
        blk("mid_block0", c0film("mid_block0")),
        blk("mid_block1", "scene"),
    ])
    chains["midB"] = chain([blk("mid_block2", "scene")])
    for j in range(n_levels):
        chains[f"upA{j}"] = chain([
            blk(f"up{j}_block0", c0film(f"up{j}_block0")),
            blk(f"up{j}_block1", "scene", has_skip=True),
        ])
        chains[f"upB{j}"] = chain([blk(f"up{j}_block2", "scene", has_skip=True)])
    chains["final"] = chain([blk("final_res_block", "scene", has_skip=True)])
    return chains


def _linear_attention_rows(p, x2, dt, B, N, heads=4, dim_head=32):
    """Linear attention on flat (M, C) rows: the to_qkv / to_out matmuls run
    flat; the (M, H*D) head tensors are viewed as (B, N, H*D) for the
    per-scene softmax and context."""
    hd = heads * dim_head
    q, k, v = (x2 @ p["to_qkv"]["kernel"]).chunk(3, dim=-1)   # (M, H*D)
    q = seg_softmax_heads(q, heads, dim_head) * (dim_head ** -0.5)
    k3 = torch.softmax(k.reshape(B, N, hd), dim=1)
    ctx = torch.einsum("bnx,bny->bxy", k3, v.reshape(B, N, hd))
    ctx = ctx * head_blockmask(heads, dim_head, ctx.dtype, ctx.device)
    out = torch.einsum("bnx,bxy->bny", q.reshape(B, N, hd), ctx).reshape(B * N, hd)
    out = _dense(p["to_out"], out)
    return _channel_layernorm(p["out_norm"]["g"], out, dt)


def _cross_attention_rows(p, x2, ctx_mat, dt, B, N, heads=4, dim_head=32):
    """A linear cross-attention block's per-step half on flat (M, C) rows:
    q = to_q(x) softmaxed within each head, the (M, H*D) queries viewed as
    (B, N, H*D) against the scene's precomputed context, then to_out and the
    output LayerNorm."""
    hd = heads * dim_head
    q = seg_softmax_heads(x2 @ p["to_q"]["kernel"], heads, dim_head) * (dim_head ** -0.5)
    out = torch.bmm(q.reshape(B, N, hd), ctx_mat).reshape(B * N, hd)
    return _channel_layernorm(p["out_norm"]["g"], _dense(p["to_out"], out), dt)


def _cross_block(misc, cross, name, h, dt, B, N):
    """h + LinearAttentionCross(LN(h), text) of the block ``name``."""
    return h + _cross_attention_rows(
        misc[name], _channel_layernorm(misc[f"{name}_norm"]["g"], h, dt), cross[name], dt, B, N)


def _full_attention_rows(p, x2, B, N, heads=4, dim_head=32):
    H, D = heads, dim_head
    q, k, v = ((x2 @ p["to_qkv"]["kernel"]).chunk(3, dim=-1))
    q4 = (q * (D ** -0.5)).reshape(B, N, H, D)
    sim = torch.einsum("bihd,bjhd->bhij", q4, k.reshape(B, N, H, D))
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, v.reshape(B, N, H, D))
    return _dense(p["to_out"], out.reshape(B * N, H * D))


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------

def _encode(net: Unet1D, prep: Dict[str, Any], x2: torch.Tensor, exact_gelu: bool):
    """Per-attribute encoder MLPs summed, then init_conv, on (M, point_dim)
    rows (denoise_net.py:512-525)."""
    misc = prep["misc"]
    if net.seperate_all:
        bd = net.bbox_dim
        h = _mlp3(misc["bbox_embedf"], x2[:, :bd], exact_gelu)
        h = h + _mlp3(misc["class_embedf"], x2[:, bd: bd + net.class_dim], exact_gelu)
        ofs = bd + net.class_dim
        if net.objectness_dim > 0:
            h = h + _mlp3(misc["objectness_embedf"], x2[:, ofs: ofs + net.objectness_dim], exact_gelu)
            ofs += net.objectness_dim
        if net.objfeat_dim > 0:
            h = h + _mlp3(misc["objfeat_embedf"], x2[:, ofs: ofs + net.objfeat_dim], exact_gelu)
    else:
        h = x2
    return _dense(misc["init_conv"], h)


def _decode(net: Unet1D, prep: Dict[str, Any], h: torch.Tensor, exact_gelu: bool):
    """Per-attribute decoder MLPs (their fc0 layers as one matmul) or the
    final conv, on (M, C) rows -> (M, out) f32."""
    misc = prep["misc"]
    if not net.seperate_all:
        return _dense(misc["final_conv"], h).float()
    approx = "none" if exact_gelu else "tanh"
    h0 = F.gelu(_dense(prep["dec_fc0"], h), approximate=approx)
    outs, ofs = [], 0
    for name in prep["dec_names"]:
        pdec = misc[name]
        w = pdec["fc0"]["kernel"].shape[1]
        hi = F.gelu(_dense(pdec["fc1"], h0[:, ofs: ofs + w]), approximate=approx)
        ofs += w
        outs.append(_dense(pdec["fc2"], hi))
    return torch.cat(outs, dim=-1).float()


def block_shapes(net: Unet1D):
    """(C, C_x, C_skip) of each of the 28 ResnetBlocks of ``net`` in the
    order of a forward (``fused_unet1d_forward``), read from the blocks'
    weights: C and C_x + C_skip are block1's projection's widths, C_skip
    the width of the skip the forward passes (an up level's block1 the
    mirrored down level's block2 output, its block2 that level's block1
    output, the final block the encoder's output)."""
    def widths(blk, skip=0):
        c, c_in = blk.block1.proj.weight.shape[:2]
        return (c, c_in - skip, skip)

    shapes = []
    for down in net.downs:
        shapes += [widths(down[0]), widths(down[1]), widths(down[3])]
    shapes += [widths(net.mid_block0), widths(net.mid_block1), widths(net.mid_block2)]
    for up, down in zip(net.ups, reversed(net.downs)):
        shapes += [widths(up[0]), widths(up[1], down[3].dim_out), widths(up[3], down[1].dim_out)]
    return shapes + [widths(net.final_res_block, net.init_conv.weight.shape[0])]


def check_card_widths(net: Unet1D) -> None:
    """Raise ``ValueError`` unless the card's ResnetBlock and set-attention
    kernels (B1, B2) take every block of ``net`` (:func:`block_shapes`) and
    its ``mid_attn``: one set for both dtypes, C = 256, 512 or 1024 in 4,
    8, 16 or 32 GroupNorm groups of at least 16 channels, inputs up to 2048
    wide (ROADMAP §C, "Known narrowing").  A model outside samples on the
    card through the module forward, ``fused=False``; nothing is launched
    before this raises."""
    dt, groups = net.compute_dtype, net.resnet_block_groups
    try:
        for C, kx, ks in block_shapes(net):
            _resblock.check_kernel_shapes(C, groups, kx, ks, 1, kx + ks != C, dt)
        _attention.check_kernel_shapes(1, net.mid_block2.dim_out, 4, 32, dt)
    except ValueError as e:
        widths = sorted({net.dim} | {net.dim * m for m in net.dim_mults})
        raise ValueError(
            f"the card's B1/B2 kernels do not take this model ({widths} wide in {groups} "
            f"groups): {e}; sample it with fused=False") from None


def check_rows_widths(net: Unet1D) -> None:
    """Raise ``ValueError`` unless the card's chain kernel (B4) takes every
    chain of ``net``'s rows engine: its level width C = dim * dim_mults[0]
    (equal ``dim_mults``) in ``resnet_block_groups`` groups within the set
    of ``ops/fused_level.py:takes``, both dtypes (C = 256, 512 or 1024 in
    4, 8, 16 or 32 groups of at least 16 channels).  A model outside
    samples on the card through the module forward, ``fused=False``;
    nothing is launched before this raises."""
    C, groups = net.dim * net.dim_mults[0], net.resnet_block_groups
    if not _level.takes(C, groups, 1):
        raise ValueError(
            f"the card's B4 chain kernel does not take this model ({C} wide in {groups} "
            f"groups; it takes C in {_resblock.SET_CHANNELS} in {_resblock.SET_GROUPS} groups "
            f"of at least {_resblock.MIN_GROUP} channels); sample it with fused=False")


@torch.no_grad()
def fused_unet1d_forward(
    net: Unet1D,
    prep: Dict[str, Any],                   # prepare_inference_params output
    x: torch.Tensor,                        # (B, N, point_dim)
    t: torch.Tensor,                        # (B,) integer timesteps
    condition: Optional[torch.Tensor] = None,   # (B, N, cond_dim)
    condition_cross: Optional[torch.Tensor] = None,  # (B, L, text_dim)
    cond_ctx: Optional[Dict[str, Any]] = None,  # precompute_conditioning output
    exact_gelu: bool = False,
) -> torch.Tensor:
    """The 3-D serving engine: functionally ``Unet1D.forward``, with every
    ResnetBlock one ``fused_resnet_block`` call (28 a forward: 9 cond-FiLM
    block0s with per-object rows, 19 time-FiLM blocks with per-scene rows, 9
    of them over a skip concat) and ``mid_attn`` one ``fused_set_attention``
    call.  A block0 without cond-FiLM rows (the unconditioned model) runs
    with zero film.  A text model's 9 cross-attention blocks are torch ops
    on the contexts of ``cond_ctx``; the mid one runs before ``mid_attn``."""
    B, N, _ = x.shape
    M = B * N
    dt = net.compute_dtype
    misc, blocks = prep["misc"], prep["blocks"]
    n_levels = len(net.dim_mults)
    groups = net.resnet_block_groups
    if cond_ctx is None:
        cond_ctx = precompute_conditioning(net, prep, condition, condition_cross)
    film_c, cross = cond_ctx["film_c"], cond_ctx["cross"]

    def resblock(name, h, film, skip=None):
        bp = blocks[name]
        b1, b2, rc = bp["block1"], bp["block2"], bp.get("res_conv")
        return fused_resnet_block(
            h, film, b1["proj"]["kernel"], b1["proj"]["bias"],
            b1["norm"]["scale"], b1["norm"]["bias"],
            b2["proj"]["kernel"], b2["proj"]["bias"],
            b2["norm"]["scale"], b2["norm"]["bias"],
            w_res=None if rc is None else rc["kernel"],
            b_res=None if rc is None else rc["bias"],
            n_per_scene=N, groups=groups, compute_dtype=dt, skip=skip)

    def cond_block(name, h):     # per-object (M, 2C) rows, or none
        f = film_c.get(name)
        return resblock(name, h, None if f is None else f.reshape(M, -1))

    def time_block(name, h, skip=None):   # per-scene (B, 2C) rows of the table
        return resblock(name, h, prep["film_t"][name][t], skip)

    h = _encode(net, prep, x.to(dt).reshape(M, -1), exact_gelu)
    r = h
    skips = []
    for i in range(n_levels):
        h = cond_block(f"down{i}_block0", h)
        h = time_block(f"down{i}_block1", h)
        skips.append(h)
        if net.text_condition:
            h = _cross_block(misc, cross, f"down{i}_attncross", h, dt, B, N)
        h = time_block(f"down{i}_block2", h)
        h = h + _linear_attention_rows(
            misc[f"down{i}_attn"],
            _channel_layernorm(misc[f"down{i}_attn_norm"]["g"], h, dt), dt, B, N)
        skips.append(h)
        if i == n_levels - 1:
            h = _dense(misc[f"down{i}_proj"], h)

    h = cond_block("mid_block0", h)
    h = time_block("mid_block1", h)
    if net.text_condition:
        h = _cross_block(misc, cross, "mid_attncross", h, dt, B, N)
    # x + Attention(LN(x)), with the model's pre-norm eps for this dtype
    ap = misc["mid_attn"]
    h = fused_set_attention(
        h.reshape(B, N, -1), misc["mid_attn_norm"]["g"], ap["to_qkv"]["kernel"],
        ap["to_out"]["kernel"], ap["to_out"]["bias"],
        eps=1e-5 if dt == torch.float32 else 1e-3, compute_dtype=dt).reshape(M, -1)
    h = time_block("mid_block2", h)

    for j in range(n_levels):
        h = cond_block(f"up{j}_block0", h)
        h = time_block(f"up{j}_block1", h, skips.pop())
        if net.text_condition:
            h = _cross_block(misc, cross, f"up{j}_attncross", h, dt, B, N)
        h = time_block(f"up{j}_block2", h, skips.pop())
        h = h + _linear_attention_rows(
            misc[f"up{j}_attn"],
            _channel_layernorm(misc[f"up{j}_attn_norm"]["g"], h, dt), dt, B, N)
        if j == n_levels - 1:
            h = _dense(misc[f"up{j}_proj"], h)

    h = time_block("final_res_block", h, r)
    return _decode(net, prep, h, exact_gelu).reshape(B, N, -1)


@torch.no_grad()
def fused_unet1d_forward_rows(
    net: Unet1D,
    prep: Dict[str, Any],     # prepare_inference_params output
    chains: Dict[str, Any],   # prepare_chain_params output
    x: torch.Tensor,          # (B, N, point_dim)
    t: torch.Tensor,          # (B,) integer timesteps
    cond_ctx_rows: Dict[str, Any],  # {"film_c2": {name: (M, 2C)}, "cross": {...}}
    exact_gelu: bool = False,
) -> torch.Tensor:
    """Functionally ``Unet1D.forward`` on configs with equal level dims;
    activations stay flat (B*N, C) and the resblock chains run through
    ``apply_chain``.  A text model's cross-attention blocks run between the
    chains, on the contexts ``cond_ctx_rows["cross"]``."""
    B, N, _ = x.shape
    M = B * N
    dt = net.compute_dtype
    misc = prep["misc"]
    n_levels = len(net.dim_mults)
    groups = net.resnet_block_groups
    film_c2 = cond_ctx_rows["film_c2"]
    cross = cond_ctx_rows.get("cross", {})

    h = _encode(net, prep, x.to(dt).reshape(M, -1), exact_gelu)
    r = h

    def run_chain(key, h, skip_rows=()):
        entry = chains[key]
        films, skips, si = [], [], 0
        for (kind, name), has_skip in zip(entry["films"], entry["skips"]):
            if kind == "scene":
                films.append(prep["film_t"][name][t])        # (B, 2C)
            elif kind == "row":
                films.append(film_c2[name])                   # (M, 2C)
            else:
                films.append(None)
            if has_skip:
                skips.append(skip_rows[si])
                si += 1
            else:
                skips.append(None)
        return apply_chain(entry["chain"], h.contiguous(), films, skips,
                           n_per_scene=N, groups=groups)

    skips = []
    for i in range(n_levels):
        h = run_chain(f"downA{i}", h)
        skips.append(h)
        if net.text_condition:
            h = _cross_block(misc, cross, f"down{i}_attncross", h, dt, B, N)
        h = run_chain(f"downB{i}", h)
        h = h + _linear_attention_rows(
            misc[f"down{i}_attn"],
            _channel_layernorm(misc[f"down{i}_attn_norm"]["g"], h, dt), dt, B, N)
        skips.append(h)
        if i == n_levels - 1:
            h = _dense(misc[f"down{i}_proj"], h)

    h = run_chain("midA", h)
    if net.text_condition:
        h = _cross_block(misc, cross, "mid_attncross", h, dt, B, N)
    h = h + _full_attention_rows(
        misc["mid_attn"], _channel_layernorm(misc["mid_attn_norm"]["g"], h, dt), B, N)
    h = run_chain("midB", h)

    for j in range(n_levels):
        h = run_chain(f"upA{j}", h, (skips.pop(),))
        if net.text_condition:
            h = _cross_block(misc, cross, f"up{j}_attncross", h, dt, B, N)
        h = run_chain(f"upB{j}", h, (skips.pop(),))
        h = h + _linear_attention_rows(
            misc[f"up{j}_attn"],
            _channel_layernorm(misc[f"up{j}_attn_norm"]["g"], h, dt), dt, B, N)
        if j == n_levels - 1:
            h = _dense(misc[f"up{j}_proj"], h)

    h = run_chain("final", h, (r,))
    return _decode(net, prep, h, exact_gelu).reshape(B, N, -1)
