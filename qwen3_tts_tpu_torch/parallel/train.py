"""Teacher-forced training step for the talker and the code predictor
(counterpart of qwen3_tts_tpu/parallel/train.py).

The step runs on the params' device: a forward over the full frame
sequence (teacher forcing), cross-entropy on the codec head and on the
code predictor's 15 heads, gradients by torch.autograd, and AdamW with
optax.adamw's update. Param trees are nested dicts of tensors; the step
updates them and the optimizer state in place and returns them, as the
JAX step returns its donated buffers.

Parallelism comes from the placement of the arguments: params placed by
parallel.sharding.shard_params (DTensors, tp-sharded q/k/v, gate/up, o and
down) and a batch placed by shard_batch (dp over the batch, optionally sp
over time). The step computes on each rank's local shards and writes the
collectives itself (sharding.Parallel): Megatron's f / g pair around each
tp region, a K/V all-gather over sp, and gradients summed over the axes the
batch is sharded on.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import Qwen3TTSConfig
from ..models.talker import codec_head, encode_audio, layer_qkv, rope_cos_sin, swiglu
from ..ops import rope as rope_ops
from ..ops.attention import causal_mask, gqa_attention_full
from ..ops.linear import linear
from ..ops.norms import rms_norm
from .sharding import SINGLE, DTensor, Parallel, local_tensor


def _unstack(tree, n: int) -> list:
    """Per-layer views of a stacked layer tree, one unbind a leaf: its
    backward stacks the layers' gradients once (a per-layer index would
    add a zero-padded full-size gradient per layer)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: s[i] for k, s in subs.items()} for i in range(n)]
    return tree.unbind(0)


def _decoder_layer(lp: dict, h: torch.Tensor, cos, sin, mask, cfg, par: Parallel):
    """One pre-norm decoder layer over all positions (talker or code
    predictor): attention with per-head q / k norms and RoPE, then SwiGLU.
    Under tp, lp holds this rank's heads and MLP columns."""
    b, t, _ = h.shape
    eps, hd = cfg.rms_norm_eps, cfg.head_dim
    x = par.enter(rms_norm(h, lp["input_layernorm"]["w"], eps))
    # q_norm / k_norm are shared by every head, so their gradients sum over
    # the tp ranks' heads: f on the weights as on the activations
    lp = dict(lp, q_norm={"w": par.enter(lp["q_norm"]["w"])},
              k_norm={"w": par.enter(lp["k_norm"]["w"])})
    q, k, v = layer_qkv(lp, x, cos, sin, cfg.num_attention_heads // par.tp_size,
                        cfg.num_key_value_heads // par.tp_size, hd, eps)
    k, v = par.gather_seq(k, 2), par.gather_seq(v, 2)
    attn = gqa_attention_full(q, k, v, 1.0 / float(hd) ** 0.5, mask)
    h = h + par.exit(linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, t, -1)))
    x2 = par.enter(rms_norm(h, lp["post_attention_layernorm"]["w"], eps))
    return h + par.exit(linear(lp["down_proj"], swiglu(lp, x2, cfg.intermediate_size)))


def _layers(layers: dict, n: int, h, cos, sin, mask, cfg, par: Parallel, remat: bool):
    for lp in _unstack(layers, n):
        if remat:  # activations recomputed layer by layer in the backward
            h = checkpoint(_decoder_layer, lp, h, cos, sin, mask, cfg, par,
                           use_reentrant=False)
        else:
            h = _decoder_layer(lp, h, cos, sin, mask, cfg, par)
    return h


def talker_forward_train(params: dict, embeds: torch.Tensor, config: Qwen3TTSConfig,
                         remat: bool = False, par: Parallel = SINGLE) -> torch.Tensor:
    """Full-sequence causal forward over input embeds [B, T, H] -> hidden
    states [B, T, H] (talker_prefill's math, keeping every position and no
    cache). Under sp, embeds hold this rank's T / sp positions: its RoPE
    positions and mask rows are offset, and K / V gather over sp.

    remat=True recomputes each layer's activations in the backward
    (torch.utils.checkpoint): the same numbers at a lower peak memory."""
    b, t, _ = embeds.shape
    off = par.sp_rank * t
    positions = torch.arange(off, off + t, device=embeds.device)[None].expand(b, t)
    cos, sin = rope_cos_sin(config, positions)
    mask = causal_mask(t, embeds.device, offset=off, keys=t * par.sp_size)
    h = _layers(params["layers"], config.num_hidden_layers, embeds, cos, sin, mask, config,
                par, remat)
    return rms_norm(h, params["norm"]["w"], config.rms_norm_eps)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target], logits fp32."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0]


def next_frame_loss(params: dict, batch: dict, config: Qwen3TTSConfig, remat: bool = False,
                    par: Parallel = SINGLE) -> torch.Tensor:
    """Teacher-forced next-code-0 cross-entropy.

    batch: {"embeds": [B, T, H] input embeddings (summed text + codec,
    already assembled), "targets": [B, T] int64 code-0 ids for the NEXT
    position, "mask": [B, T] float, 1.0 where the target is real}. Under dp /
    sp the mask sum is the global one."""
    h = talker_forward_train(params, batch["embeds"], config, remat, par)
    nll = _nll(codec_head(params, h), batch["targets"])
    mask = batch["mask"].float()
    return (nll * mask).sum() / par.total(mask.sum()).clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw's update: moments m, v with b1 0.9, b2 0.999, bias
    corrected by the step count, u = m_hat / (sqrt(v_hat) + eps) (eps_root
    0), the decay added, p -= lr * (u + wd * p). Every leaf decays, also one
    the loss never reads: its gradient is zero, not absent.

    The state is a nested dict: {"count": int64 scalar, "mu": tree, "nu":
    tree}, the moments shaped and placed as the params."""

    lr: float = 1e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> dict:
        first = local_tensor(_flatten(params)[1][0])
        return {"count": torch.zeros((), dtype=torch.int64, device=first.device),
                "mu": _map(torch.zeros_like, params), "nu": _map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params: list, grads: list, state: dict) -> None:
        """One step in place on the local tensors `params` (flattened in
        the params tree's order), their gradients and `state`."""
        count = local_tensor(state["count"])
        count.add_(1)
        c = count.float()  # bias corrections stay on the device
        bc1, bc2 = 1 - self.b1 ** c, 1 - self.b2 ** c
        mus = [local_tensor(m) for m in _flatten(state["mu"])[1]]
        nus = [local_tensor(v) for v in _flatten(state["nu"])[1]]
        for p, g, m, v in zip(params, grads, mus, nus, strict=True):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            p.add_(u.add_(p, alpha=self.weight_decay), alpha=-self.lr)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def _flatten(tree: dict, prefix: tuple = ()) -> tuple[list, list]:
    """(paths, leaves) of a nested dict, in insertion order."""
    paths, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            p, lv = _flatten(v, prefix + (k,))
            paths += p
            leaves += lv
        else:
            paths.append(prefix + (k,))
            leaves.append(v)
    return paths, leaves


def _unflatten(paths: list, leaves: list) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _value_and_grad(loss_fn, params: dict, batch: dict):
    """(loss, parts, local leaves, gradients) of loss_fn(tree, batch, par)
    -> (loss, parts) at `params`, the gradients summed over the batch's
    sharded axes; leaves the loss never reads get zero gradients (as
    jax.value_and_grad gives them). loss and parts are the global values."""
    paths, leaves = _flatten(params)
    par = Parallel.of(leaves, batch)
    local = [local_tensor(p) for p in leaves]
    work = [p.detach().requires_grad_() for p in local]
    with torch.enable_grad():
        loss, parts = loss_fn(_unflatten(paths, work), {k: local_tensor(v) for k, v in
                                                        batch.items()}, par)
        grads = torch.autograd.grad(loss, work, allow_unused=True)
    # contiguous: collectives take dense tensors
    grads = [torch.zeros_like(w) if g is None else g.contiguous() for g, w in zip(grads, work)]
    par.sync_grads(grads)
    return (par.total(loss.detach()), {k: par.total(v.detach()) for k, v in parts.items()},
            local, grads)


def _grad_tree(params: dict, grads: list) -> dict:
    """Gradients as a tree shaped and placed as `params`."""
    paths, leaves = _flatten(params)
    return _unflatten(paths, [
        DTensor.from_local(g, p.device_mesh, p.placements, run_check=False)
        if isinstance(p, DTensor) else g for p, g in zip(leaves, grads)])


def make_train_step(config: Qwen3TTSConfig, optimizer: AdamW | None = None,
                    remat: bool = False):
    """(optimizer, step) with step(params, opt_state, batch) -> (params,
    opt_state, loss) on next_frame_loss, params and state updated in place."""
    optimizer = optimizer or make_optimizer()

    def loss_fn(params, batch, par):
        return next_frame_loss(params, batch, config, remat, par), {}

    def step(params, opt_state, batch):
        loss, _, local, grads = _value_and_grad(loss_fn, params, batch)
        optimizer.update_(local, grads, opt_state)
        return params, opt_state, loss

    return optimizer, step


# ---------------------------------------------------------------------------
# Full TTS loss: code-0 head + teacher-forced code-predictor groups
# ---------------------------------------------------------------------------


def cp_forward_train(cp_params: dict, x: torch.Tensor, cfg, remat: bool = False) -> torch.Tensor:
    """Full-sequence causal forward of the code predictor for teacher
    forcing: x [N, 16, H_in] (token 0 = talker hidden, token 1 = talker
    codec embed of code 0, token k+1 = cp group-(k-1) embed of code k).
    Returns all hidden states [N, 16, Hc]. Per position, so it runs on
    each rank's own positions under dp / sp, replicated over tp."""
    if "small_to_mtp_projection" in cp_params:
        x = linear(cp_params["small_to_mtp_projection"], x)
    l = x.shape[1]
    inv = rope_ops.inv_freq_tensor(cfg.head_dim, cfg.rope_theta, x.device)
    cos, sin = rope_ops.rope_cos_sin(torch.arange(l, device=x.device)[None], inv)
    h = _layers(cp_params["layers"], cfg.num_hidden_layers, x, cos, sin,
                causal_mask(l, x.device), cfg, SINGLE, remat)
    return rms_norm(h, cp_params["norm"]["w"], cfg.rms_norm_eps)


def tts_loss(params: dict, cp_params: dict, batch: dict, config: Qwen3TTSConfig,
             remat: bool = False, par: Parallel = SINGLE) -> tuple[torch.Tensor, dict]:
    """Joint teacher-forced TTS loss mirroring inference.

    batch: {"embeds": [B, T, H] input embeddings (text hidden + summed codec
    embeds of the PREVIOUS frame, as the decode loop builds them),
    "frames": [B, T, 16] int64 target codec frames, "mask": [B, T] float}.
    Returns (total_loss, {"code0": ..., "cp": ...}). The code predictor's
    inputs and targets clip codes to [0, cp vocab); its 15th embedding
    table is never read."""
    cp_cfg = config.code_predictor_config
    ng = cp_cfg.num_code_groups  # 16
    h = talker_forward_train(params, batch["embeds"], config, remat, par)
    b, t, hdim = h.shape
    mask = batch["mask"].float()
    denom = par.total(mask.sum()).clamp_min(1.0)
    frames = batch["frames"]

    loss0 = (_nll(codec_head(params, h), frames[..., 0]) * mask).sum() / denom

    frames = frames.reshape(b * t, ng)
    code0_emb = encode_audio(params, frames[:, 0])[:, None]  # talker table
    tables = cp_params["codec_embedding"]["w"]  # [15, V, H]
    # token k+1 (k = 1..14) is cp table k-1 at the TRUE code of group k
    group_codes = frames.T[1:ng - 1].clamp(0, cp_cfg.vocab_size - 1)  # [14, N]
    groups = torch.arange(ng - 2, device=frames.device)[:, None]
    group_embs = tables[groups, group_codes]  # [14, N, H]
    x = torch.cat([h.reshape(b * t, 1, hdim), code0_emb, group_embs.transpose(0, 1)],
                  dim=1).to(h.dtype)  # [N, 16, H]
    cp_h = cp_forward_train(cp_params, x, cp_cfg, remat)  # [N, 16, Hc]

    # position k+1 predicts group k+1's code through lm_head[k]
    logits_cp = torch.einsum("nkh,kvh->nkv", cp_h[:, 1:ng].float(),
                             cp_params["lm_head"]["w"].float())
    nll_cp = _nll(logits_cp, frames[:, 1:ng].clamp(0, cp_cfg.vocab_size - 1))
    loss_cp = (nll_cp * mask.reshape(b * t, 1)).sum() / (denom * (ng - 1))
    return loss0 + loss_cp, {"code0": loss0, "cp": loss_cp}


def tts_value_and_grad(both: dict, batch: dict, config: Qwen3TTSConfig, remat: bool = False):
    """(loss, parts, grads) of tts_loss at both = {"talker", "cp"}: what the
    train step computes before its update. grads is shaped and placed as
    `both` (DTensors where its leaves are), summed over the batch's sharded
    axes."""
    loss, parts, _, grads = _value_and_grad(_tts_loss_fn(config, remat), both, batch)
    return loss, parts, _grad_tree(both, grads)


def _tts_loss_fn(config: Qwen3TTSConfig, remat: bool):
    def loss_fn(both, batch, par):
        return tts_loss(both["talker"], both["cp"], batch, config, remat, par)

    return loss_fn


def make_tts_train_step(config: Qwen3TTSConfig, optimizer: AdamW | None = None,
                        remat: bool = False):
    """(optimizer, step) with step(both, opt_state, batch) -> (both,
    opt_state, loss, parts): the joint talker + code-predictor step, both
    and opt_state updated in place. remat=True recomputes both stacks'
    layer activations in the backward."""
    optimizer = optimizer or make_optimizer()
    loss_fn = _tts_loss_fn(config, remat)

    def step(both, opt_state, batch):
        loss, parts, local, grads = _value_and_grad(loss_fn, both, batch)
        optimizer.update_(local, grads, opt_state)
        return both, opt_state, loss, parts

    return optimizer, step
