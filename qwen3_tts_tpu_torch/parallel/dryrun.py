"""Multi-process dry runs of the sharded train step and of tp-sharded
inference, on the CPU (gloo) or on one card shared by the ranks.

The counterpart of the JAX package's `dryrun_multichip`. Training:
`run_meshes(world_size, [(tp, sp, overrides), ...])` starts `world_size`
gloo processes (spawned, rendezvous through a file in a temporary
directory, no TCP port to pick) and, for each case, builds a (dp, tp) or
(dp, sp, tp) mesh, shards a tiny talker Megatron-style, places the batch on
dp (and its time axis on sp), and runs one make_tts_train_step step. It
returns rank 0's loss, parts, gradients and updated params as full tensors,
to hold against the single-process step on the same inputs (`problem`);
several meshes of one world size share one group of processes (one
start-up).

Inference: `run_inference(problem, cases)` runs, in one group of two
spawned processes with a (dp = 1, tp = 2) and a (dp = 2, tp = 1) mesh, the
counterparts of dryrun_multichip's five inference sections on a talker
placed by shard_params: single-stream prefill + decode_chunk, the serving
prefill_batched + decode_chunk_serving at B = 2, a park / admit cycle, a
dp-sharded batched vocode, and TTSService with rank 0 serving and rank 1
following. Each case returns rank 0's frames, counts, EOS flags, talker
logits teacher-forced on given frames, cache shapes and waveforms.

    python -m qwen3_tts_tpu_torch.parallel.dryrun 4 2 2   # train: world, tp, sp
    python -m qwen3_tts_tpu_torch.parallel.dryrun infer   # inference, 2 ranks

Every process group and join times out (`timeout_s`), so a hang fails.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..convert import to_torch, vocoder_params
from ..testing import (
    FakeByteTokenizer,
    random_host_cp_params,
    random_host_talker_params,
    random_vocoder_params,
    tiny_decoder_config,
    tiny_talker_config,
)
from . import sharding as sh
from . import train

B, T = 4, 8  # the batch splits over dp = 2 and its time axis over sp = 2


def problem(seed: int = 0, **overrides):
    """(config, talker, cp, batch): the tiny config with `overrides`, fp32
    CPU params from `seed` (fused layout) and a batch whose frames reach
    past the code predictor's vocabulary (clipped) and whose mask has
    zeros."""
    config = tiny_talker_config(**overrides)
    talker = to_torch(random_host_talker_params(config, seed))
    cp = to_torch(random_host_cp_params(config, seed + 1))
    rng = np.random.default_rng(seed + 2)
    mask = np.ones((B, T), np.float32)
    mask[1, -3:] = 0.0
    batch = {
        "embeds": torch.from_numpy(rng.standard_normal((B, T, config.hidden_size),
                                                       dtype=np.float32)),
        "frames": torch.from_numpy(rng.integers(
            0, config.vocab_size, (B, T, config.code_predictor_config.num_code_groups))),
        "mask": torch.from_numpy(mask),
    }
    return config, talker, cp, batch


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, sh.DTensor) else tree


def _worker(rank: int, world_size: int, cases: list, root: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    sh.init_process_group("cpu", rank, world_size, f"file://{root}/rendezvous", timeout_s)
    try:
        for i, (tp, sp, overrides) in enumerate(cases):
            mesh = sh.make_mesh(world_size, tp=tp, sp=sp)
            config, talker, cp, batch = problem(**overrides)
            sh.validate_tp_divisibility(config, tp)
            both = {"talker": sh.shard_params(talker, mesh, config=config), "cp": cp}
            batch = sh.shard_batch(batch, mesh, sp=sp > 1)
            _, _, grads = train.tts_value_and_grad(both, batch, config)
            optimizer, step = train.make_tts_train_step(config)
            opt_state = optimizer.init(both)
            both, opt_state, loss, parts = step(both, opt_state, batch)
            out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), "loss": loss,
                   "parts": parts, "grads": _full(grads), "params": _full(both)}
            if rank == 0:
                torch.save(out, os.path.join(root, f"result{i}.pt"))
    finally:
        dist.destroy_process_group()


def run_meshes(world_size: int, cases: list[tuple[int, int, dict]],
               timeout_s: float = 60.0) -> list[dict]:
    """One sharded train step for each (tp, sp, overrides) of `cases`, all in
    one group of `world_size` spawned gloo processes (one start-up for
    several meshes), each on problem(**overrides). Returns, per case,
    {"mesh": {axis: size}, "loss", "parts", "grads", "params"} from rank 0,
    every tensor full (gathered over tp), params after the step in the
    unfused layout. Raises TimeoutError after `timeout_s` seconds for the
    whole group, and a worker's own error if one fails."""
    with tempfile.TemporaryDirectory() as root:
        spawn_group(_worker, (world_size, cases, root, timeout_s), world_size, timeout_s,
                    f"dry run (world {world_size}, cases {cases})")
        return [torch.load(os.path.join(root, f"result{i}.pt"), weights_only=True)
                for i in range(len(cases))]


# ---------------------------------------------------------------------------
# tp-sharded inference
# ---------------------------------------------------------------------------

SENTENCE = "Multichip serving dryrun sentence."
SERVE_TEXTS = (SENTENCE, "A second stream joins the batch.")
FRESH_TEXT = "A fresh request takes the parked slot."
SERVICE_TEXTS = ("Mesh service request one goes first.",
                 "Mesh service request two joins the batch.",
                 "Mesh service request three waits for admission.")
STEPS, CHUNK = 8, 4  # frames a stream decodes, in chunks of CHUNK
SERVICE = dict(batch_size=2, chunk_steps=4, decode_chunk=6, left_context=3,
               trailing_bucket=128)
SERVICE_MAX_TOKENS = 8
INFERENCE_CASES = ("single", "serving", "cycle", "vocode", "service")


def inference_problem(seed: int = 0, decoder=None) -> dict:
    """The tiny config, its talker, code predictor and vocoder (`decoder`,
    default the tiny one) as numpy trees from `seed`, and vocoder codes
    [2, nq, 12]."""
    config = tiny_talker_config()
    dec = decoder or tiny_decoder_config(codebook_size=config.code_predictor_config.vocab_size)
    rng = np.random.default_rng(seed + 3)
    return {"config": config, "talker": random_host_talker_params(config, seed),
            "cp": random_host_cp_params(config, seed + 1), "decoder": dec,
            "vocoder": _numpy(random_vocoder_params(dec, seed + 2)),
            "codes": rng.integers(0, dec.codebook_size, (2, dec.num_quantizers, 12))}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _clone(tree):
    if isinstance(tree, dict):
        return type(tree)({k: _clone(v) for k, v in tree.items()})
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of t on the host (fp32 when floating): never the state's own
    tensor, which the next step updates in place."""
    t = t.detach().to("cpu", copy=True)
    return t.float() if t.is_floating_point() else t


def _launches() -> dict:
    from ..ops.cuda import cp_megakernel, pretransformer_kernel, upsample_kernel
    from ..ops.cuda import vocoder_kernels

    return {"cp_frame": cp_megakernel.launches,
            "pre_transformer": pretransformer_kernel.launches,
            "upsample_stage": upsample_kernel.launches,
            "residual_units": vocoder_kernels.launches,
            "block_upsample": vocoder_kernels.upsample_launches}


def greedy_scores(state: dict, config, total_key: str, penalty: float = 1.05) -> torch.Tensor:
    """The scores a greedy step takes code 0 from (sample_token at
    temperature 0: the eos / pad mask while text remains, the repetition
    penalty on seen codes, the validity mask), fp32, masked codes -inf;
    [V] for a single-stream state (total_key "total_text"), [B, V] for a
    serving state ("total_texts")."""
    from ..models import generate as gen
    from ..ops.sampling import NEG_INF

    eos_pad, valid = gen.step_masks(config, state["logits"].device)
    has_text = state["trailing_idx"] < state[total_key]
    lg = (state["logits"] + torch.where(has_text[..., None], eos_pad, 0.0)).float()
    lg = lg / torch.where(state["seen_code0"], penalty, 1.0)
    return torch.where(valid & (lg > float(NEG_INF) / 2), lg, float("-inf"))


def _models(problem: dict, dev, dtype, kernels: bool) -> SimpleNamespace:
    """The problem's trees on this rank's device: talker (plain), cp,
    vocoder; `kernels` adds K2's tree to cp and K4-K6's to the vocoder."""
    from ..ops.cuda.cp_megakernel import build_cp_kernel_params

    cfg = problem["config"]
    cp = to_torch(problem["cp"], dev, dtype)
    if kernels:
        cp["kernel"] = to_torch(build_cp_kernel_params(problem["cp"], cfg.code_predictor_config),
                                dev, torch.float32)
    return SimpleNamespace(
        config=cfg, dec=problem["decoder"], dev=dev, cp=cp,
        talker=to_torch(problem["talker"], dev, dtype),
        vocoder=vocoder_params(problem["vocoder"], problem["decoder"], dev,
                               kernel_dtype=dtype if kernels else None))


def _single(m, params: dict, forced) -> dict:
    """prefill + decode_chunk greedy on the placed tree ("sharded") and,
    with no `forced` frames, on the plain tree ("plain", no collective);
    two of the stream stacked (stack_states, decode_chunk_batched, 2
    frames) on the placed tree; then each a teacher-forced pass over `forced` [n, 16] (default: the
    plain run's frames): per step the code-0 scores before it, the port's
    own greedy frame from that state, and the talker logits after it."""
    from ..models import generate as gen
    from ..models import prompt as prompt_mod
    from ..models import vocoder as voc

    cfg, tok = m.config, FakeByteTokenizer()
    pd = prompt_mod.assemble_prompt(params, cfg, tok, SENTENCE, speaker="aiden")
    cap = gen.pick_bucket(pd.input_embeds.shape[1]) + gen.RING_SLACK
    greedy = dict(temperature=0.0, generator=None, track_cp_penalty=False)
    trees = {"sharded": params} if forced is not None else {"plain": m.talker,
                                                            "sharded": params}
    out = {}
    for name, tree in trees.items():
        st = gen.prefill(tree, pd, cfg, capacity=cap)
        frames, count, eos = gen.decode_chunk(tree, m.cp, st, cfg, steps=STEPS, **greedy)
        out[name] = {"frames": frames.cpu(), "count": int(count), "eos": bool(eos),
                     "kv_heads": st["cache"]["k"].shape[2]}
    # two of the stream side by side on the local caches (stack_states)
    stacked = gen.stack_states([gen.prefill(params, pd, cfg, capacity=cap) for _ in range(2)])
    frames, _, _ = gen.decode_chunk_batched(params, m.cp, stacked, cfg, steps=2,
                                            temperature=0.0, track_cp_penalty=False)
    out["sharded"]["batched"] = {"frames": frames.cpu(),
                                 "cache_shape": tuple(stacked["cache"]["k"].shape)}
    if forced is None:
        forced = out["plain"]["frames"][:out["plain"]["count"]]
    forced = torch.as_tensor(np.asarray(forced), dtype=torch.int64, device=m.dev)
    for name, tree in trees.items():
        st = gen.prefill(tree, pd, cfg, capacity=cap)
        scores, picks, logits = [], [], [_host(st["logits"])]
        for f in forced:
            scores.append(greedy_scores(st, cfg, "total_text").cpu())
            free, _ = gen.decode_step(tree, m.cp, _clone(st), cfg, **greedy)
            picks.append(free.cpu())
            gen.decode_step(tree, m.cp, st, cfg, forced_frame=f, **greedy)
            logits.append(_host(st["logits"]))
        out[name]["tf"] = _stacked(scores, picks, logits)
    f = out["sharded"]["frames"][:out["sharded"]["count"]]
    if len(f):  # the vocoder on the stream's frames (K4-K6 with kernels)
        out["wav"] = voc.decode_frames(m.vocoder, f.T[None].to(m.dev), m.dec).cpu()
    return out


def _stacked(scores, picks, logits) -> dict:
    """A teacher-forced pass's lists as tensors: scores and picks [n, ...]
    (empty when n = 0), logits [n + 1, ...] (the prefill's first)."""
    return {"scores": torch.stack(scores) if scores else torch.zeros(0),
            "picks": torch.stack(picks) if picks else torch.zeros(0, dtype=torch.int64),
            "logits": torch.stack(logits)}


def _prefill_rows(m, params: dict, texts, seeds, pb: int, tb: int, statics):
    from ..models import prompt as prompt_mod
    from ..models import serving as srv

    tok = FakeByteTokenizer()
    pds = [prompt_mod.assemble_prompt(params, m.config, tok, t, speaker="aiden") for t in texts]
    e, tr, lengths, totals = srv._pad_prompts(pds, pb, tb)
    return srv.prefill_batched(params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                               srv._device_ints(seeds, m.dev), statics)


def _serve_buckets(m, params: dict):
    """(prompt bucket, trailing bucket, GenStatics) of SERVE_TEXTS and
    FRESH_TEXT."""
    from ..models import generate as gen
    from ..models import prompt as prompt_mod

    tok = FakeByteTokenizer()
    pds = [prompt_mod.assemble_prompt(params, m.config, tok, t, speaker="aiden")
           for t in (*SERVE_TEXTS, FRESH_TEXT)]
    pb = gen.pick_bucket(max(pd.input_embeds.shape[1] for pd in pds))
    tb = gen.pick_bucket(max(pd.trailing_hidden.shape[1] for pd in pds), gen.TRAILING_BUCKETS)
    return pb, tb, gen.GenStatics(config=m.config, capacity=pb + gen.RING_SLACK,
                                  chunk_steps=CHUNK, track_cp_penalty=False)


def _serving(m, params: dict, forced) -> dict:
    """prefill_batched of SERVE_TEXTS (B = 2, seeds 0, 1) and STEPS greedy
    steps in chunks of CHUNK, on the placed tree and, with no `forced`
    frames, the plain one; then each the eager lockstep step
    teacher-forced over the leading steps of `forced` [2, n, 16] where
    both streams emitted (default: the plain run's frames): per step the
    code-0 scores before it, the free greedy frame and the logits after."""
    from ..models import serving as srv

    pb, tb, statics = _serve_buckets(m, params)
    trees = {"sharded": params} if forced is not None else {"plain": m.talker,
                                                            "sharded": params}
    out = {}
    for name, tree in trees.items():
        st = _prefill_rows(m, tree, SERVE_TEXTS, [0, 1], pb, tb, statics)
        kv = st["cache"]["k"].shape[2]
        chunks = []
        for _ in range(STEPS // CHUNK):
            frames, counts, eos, st = srv.decode_chunk_serving(tree, m.cp, st, 0.0, statics)
            chunks.append((frames, counts, eos))
        out[name] = {"frames": torch.cat([c[0] for c in chunks], 1).cpu(),
                     "counts": sum(c[1] for c in chunks).cpu(), "eos": chunks[-1][2].cpu(),
                     "kv_heads": kv}
    if forced is None:
        forced = out["plain"]["frames"]
    forced = torch.as_tensor(np.asarray(forced), dtype=torch.int64, device=m.dev)
    n = int((forced[..., 0] >= 0).all(0).long().cumprod(0).sum())
    zeros = torch.zeros(2, device=m.dev)
    cp = srv._drop_kernel(m.cp)
    for name, tree in trees.items():
        st = _prefill_rows(m, tree, SERVE_TEXTS, [0, 1], pb, tb, statics)
        scores, picks, logits = [], [], [_host(st["logits"])]
        for i in range(n):
            scores.append(greedy_scores(st, m.config, "total_texts").cpu())
            free = _clone(st)
            srv.lockstep_step(tree, cp, free, zeros, statics, False)
            picks.append(_host(free["frame"]))
            srv.lockstep_step(tree, cp, st, zeros, statics, False, forced=forced[:, i])
            logits.append(_host(st["logits"]))
        out[name]["tf"] = _stacked(scores, picks, logits)
    return out


def _cycle(m, params: dict) -> dict:
    """The continuous-batching cycle the service runs at a boundary:
    prefill_batched (B = 2), a chunk, park_slot(0), a B = 1 prefill of
    FRESH_TEXT (seed 99) admitted into slot 0, a chunk. Frames of both
    chunks and the state's cache shape and logits after them."""
    from ..models import serving as srv

    pb, tb, statics = _serve_buckets(m, params)
    st = _prefill_rows(m, params, SERVE_TEXTS, [0, 1], pb, tb, statics)
    fa, _, _, st = srv.decode_chunk_serving(params, m.cp, st, 0.0, statics)
    srv.park_slot(st, 0)
    fresh = _prefill_rows(m, params, (FRESH_TEXT,), [99], pb, tb, statics)
    srv.admit_stream(st, 0, fresh, statics)
    fb, counts, eos, st = srv.decode_chunk_serving(params, m.cp, st, 0.0, statics)
    return {"fa": fa.cpu(), "fb": fb.cpu(), "counts": counts.cpu(), "eos": eos.cpu(),
            "logits": _host(st["logits"]), "cache_shape": tuple(st["cache"]["k"].shape)}


def _vocode(m, dp_mesh, codes) -> dict:
    """decode_frames of codes placed on "dp": each rank decodes its rows;
    the waveform gathered on the host."""
    from ..models import vocoder as voc

    placed = sh._place(torch.as_tensor(np.asarray(codes)).long(), dp_mesh, ("dp", None, None))
    wav = voc.decode_frames(m.vocoder, placed, m.dec)
    return {"wav": sh.gather_rows(wav), "local_rows": wav.to_local().shape[0],
            "placements": [str(p) for p in wav.placements]}


def _service(m, params: dict, rank: int) -> dict | None:
    """TTSService on tp rank 0 (rank 1 follows): SERVICE_TEXTS submitted at
    once at temperature 0, two bootstrapped and the third admitted when a
    slot frees. Per request its audio and chunk token ranges."""
    from ..service import TTSService

    pl = SimpleNamespace(
        config=m.config, params=params, cp_params=m.cp, tokenizer=FakeByteTokenizer(),
        speech_config=SimpleNamespace(decoder_config=m.dec), vocoder_params=m.vocoder,
        pipeline_config=SimpleNamespace(default_temperature=0.0, default_max_tokens=10))
    if rank != 0:
        TTSService.follow(pl, **SERVICE)
        return None
    return serve_texts(pl, SERVICE_TEXTS)


def serve_texts(pl, texts) -> dict:
    """A TTSService(pl, **SERVICE) serving `texts` at temperature 0 (seed =
    index), then closed: per request its audio and chunk token ranges."""
    from ..service import TTSService

    svc = TTSService(pl, **SERVICE)
    try:
        reqs = [svc.submit(t, "aiden", temperature=0.0, max_tokens=SERVICE_MAX_TOKENS, seed=i)
                for i, t in enumerate(texts)]
        out = {"audio": [], "ranges": []}
        for r in reqs:
            chunks = list(r.chunks())
            parts = [c.samples for c in chunks if len(c.samples)]
            out["audio"].append(np.concatenate(parts) if parts else np.zeros(0, np.float32))
            out["ranges"].append([c.token_range for c in chunks])
        out["stats"] = svc.stats()
    finally:
        svc.close()
    return out


def _infer_worker(rank: int, world_size: int, problem: dict, cases: list, forced: dict,
                  root: str, timeout_s: float, device: str, dtype, kernels: bool) -> None:
    from ..models import serving as srv

    torch.set_num_threads(1)
    sh.init_process_group(device, rank, world_size, f"file://{root}/rendezvous", timeout_s,
                          backend="gloo")
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        tp_mesh = sh.make_mesh(world_size, tp=world_size)
        dp_mesh = sh.make_mesh(world_size, tp=1)
        m = _models(problem, dev, dtype, kernels)
        sharded = sh.shard_params(m.talker, tp_mesh, config=m.config)
        binds = []
        real_bind = srv.bind

        def bind(params, *args, **kwargs):  # counts every bind the cases make
            binds.append(sh.is_placed(params))
            return real_bind(params, *args, **kwargs)

        srv.bind = bind
        out = {"mesh": {"tp": dict(zip(tp_mesh.mesh_dim_names, tp_mesh.mesh.shape)),
                        "dp": dict(zip(dp_mesh.mesh_dim_names, dp_mesh.mesh.shape))},
               "backend": dist.get_backend()}
        for case in cases:
            before = _launches()
            sh.Parallel.reduces = 0
            if case == "single":
                res = _single(m, sharded, forced.get(case))
            elif case == "serving":
                res = _serving(m, sharded, forced.get(case))
            elif case == "cycle":
                res = _cycle(m, sharded)
            elif case == "vocode":
                res = _vocode(m, dp_mesh, problem["codes"])
            else:
                res = _service(m, sharded, rank)
            if res is not None:
                res["launches"] = {k: v - before[k] for k, v in _launches().items()}
                res["reduces"] = sh.Parallel.reduces
            out[case] = res
        srv.bind = real_bind
        out["sharded_binds"] = sum(binds)
        try:
            srv.bind(sharded, m.cp, {"logits": torch.zeros(1)}, None, False)
            out["bind_refuses_placed"] = False
        except ValueError:
            out["bind_refuses_placed"] = True
        if rank == 0:
            torch.save(out, os.path.join(root, "inference.pt"))
    finally:
        dist.destroy_process_group()


def run_inference(problem: dict | None = None, cases=INFERENCE_CASES, forced: dict | None = None,
                  *, device: str = "cpu", dtype=torch.float32, kernels: bool = False,
                  timeout_s: float = 120.0) -> dict:
    """The inference cases (INFERENCE_CASES, in the order given) on one
    group of two spawned gloo processes, with a (dp = 1, tp = 2) mesh for
    the talker and a (dp = 2, tp = 1) mesh for the vocode, on the CPU or
    on one card both ranks share (device="cuda"; kernels=True adds K2's
    and K4-K6's trees). `problem`: inference_problem()'s layout (the
    default from seed 0). `forced`: case -> frames to teacher-force the
    single ([n, 16]) and serving ([2, n, 16]) cases on; absent, each
    rank's plain-tree run's frames (returned under "plain"). Returns rank
    0's results per case, with the meshes, the backend, the launches of
    the kernel wrappers per case, the all-reduces per case, how many binds
    a placed tree reached ("sharded_binds", none expected) and whether
    bind refuses a placed tree."""
    problem = inference_problem() if problem is None else problem
    with tempfile.TemporaryDirectory() as root:
        args = (2, problem, list(cases), forced or {}, root, timeout_s, device, dtype, kernels)
        spawn_group(_infer_worker, args, 2, timeout_s, f"inference dry run {list(cases)}")
        return torch.load(os.path.join(root, "inference.pt"), weights_only=False)


def spawn_group(worker, args: tuple, nprocs: int, timeout_s: float, label: str) -> None:
    """worker(rank, *args) in `nprocs` spawned processes, joined; raises
    TimeoutError after `timeout_s` (killing them) and a worker's own error
    if one fails."""
    ctx = mp.start_processes(worker, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{label} did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30))


def main_inference() -> int:
    """The five cases on the tiny problem, the single stream and serving
    held against the plain tree's run on the same rank; one line a case."""
    out = run_inference()
    print(f"inference dry run: backend {out['backend']}, meshes {out['mesh']}")
    ok = out["sharded_binds"] == 0 and out["bind_refuses_placed"]
    for name in ("single", "serving"):
        sharded, plain = out[name]["sharded"], out[name]["plain"]
        same = torch.equal(sharded["frames"], plain["frames"])
        err = _rel(sharded["tf"]["logits"], plain["tf"]["logits"])
        ok = ok and same and err <= 1e-4
        print(f"  {name}: frames {'equal' if same else 'DIFFER'} to the plain tree's; "
              f"teacher-forced logits rel RMS {err:.2e} over "
              f"{len(sharded['tf']['logits']) - 1} steps; local KV heads "
              f"{sharded['kv_heads']} of {plain['kv_heads']}; {out[name]['reduces']} "
              f"all-reduces")
    cyc, voc, svc = out["cycle"], out["vocode"], out["service"]
    print(f"  cycle: frames {tuple(cyc['fa'].shape)} then {tuple(cyc['fb'].shape)} after "
          f"park_slot + admit_stream; cache {cyc['cache_shape']}")
    print(f"  vocode: {voc['local_rows']} rows a rank, waveform {tuple(voc['wav'].shape)}, "
          f"placed {voc['placements']}")
    print(f"  service: {len(svc['audio'])} requests, audio lengths "
          f"{[len(a) for a in svc['audio']]}; binds of the placed tree "
          f"{out['sharded_binds']}, bind refuses it: {out['bind_refuses_placed']}")
    print("inference dry run ok" if ok else "inference dry run FAILED")
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    if argv[:1] == ["infer"]:
        return main_inference()
    world, tp, sp = (int(a) for a in (argv + ["2", "2", "1"][len(argv):]))
    overrides = {} if 2 % tp == 0 else {"num_attention_heads": 8, "num_key_value_heads": 4}
    out = run_meshes(world, [(tp, sp, overrides)])[0]
    print(f"dry run ok: mesh {out['mesh']}, loss {float(out['loss']):.6f} (code0 "
          f"{float(out['parts']['code0']):.6f}, cp {float(out['parts']['cp']):.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
