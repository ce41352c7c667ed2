"""Device mesh and sharding layout for the talker, in training and in
inference (counterpart of qwen3_tts_tpu/parallel/sharding.py).

A (dp, tp) `DeviceMesh` over torch.distributed, or (dp, sp, tp) with
sequence parallelism. Megatron-style tensor parallelism over attention
heads and MLP columns, in JAX's layout (stacked layer weights, leading
axis = layer):
  q / k / v   [L, heads*hd, H] -> axis 1 on "tp" (column-parallel)
  gate / up   [L, I, H]        -> axis 1 on "tp" (column-parallel)
  o_proj      [L, H, heads*hd] -> axis 2 on "tp" (row-parallel)
  down_proj   [L, H, I]        -> axis 2 on "tp" (row-parallel)
  norms, embeddings, codec_head and the code predictor: replicated
The batch is on "dp", its time axis on "sp" when asked for.

JAX gets its collectives from GSPMD. Here each leaf is a DTensor that
records its placement (checkpoints and restores read it), and the train
step computes on the local shards with collectives written out
(`Parallel`): f (identity forward, all-reduce backward) before each
column-parallel product, g (all-reduce forward, identity backward) after
each row-parallel one, K / V all-gathered over sp (the backward sums over
sp and keeps the rank's rows), and gradients summed over the axes the
batch is sharded on. Inference reads the same placement
(`local_params`): each talker function computes on the rank's local
shards with the local head counts and sums the row-parallel products over
tp (`Parallel.reduce`), with no autograd: each rank's partial sums are
summed in fp32 and cast back to the activations' dtype, so the sum's order
adds no bf16 rounding of its own over the 2 x layers reductions a step.

The backend is nccl for CUDA tensors and gloo for CPU ones by default;
gloo also carries CUDA tensors (all_reduce and broadcast, not all_gather),
so two ranks can share one card, which nccl refuses. CUDA asked for and
absent raises.
"""

from __future__ import annotations

import datetime
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..config import Qwen3TTSConfig
from ..utils.device import resolve_device

__all__ = [
    "DTensor",
    "Parallel",
    "gather_rows",
    "init_process_group",
    "is_placed",
    "local_params",
    "local_tensor",
    "make_mesh",
    "shard_batch",
    "shard_params",
    "talker_param_pspecs",
    "unfuse_qkv_gateup",
    "validate_tp_divisibility",
]


# the device type of the tensors the default group carries, set by
# init_process_group (make_mesh builds its meshes on it)
_GROUP_DEVICE: list = [None]


def init_process_group(device="cuda", rank: int = 0, world_size: int = 1,
                       init_method: str | None = None, timeout_s: float = 60.0,
                       backend: str | None = None) -> None:
    """Join the default process group for tensors on `device`: the backend
    is nccl for a CUDA device (RuntimeError without CUDA) and gloo for the
    CPU unless `backend` names one; backend="gloo" with a CUDA device puts
    several ranks on one card. A CUDA rank uses card rank % device count.
    Collectives time out after `timeout_s`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl carries CUDA tensors only")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _GROUP_DEVICE[0] = dev.type


def make_mesh(n_devices: int | None = None, tp: int | None = None, sp: int = 1) -> DeviceMesh:
    """A (dp, tp) mesh over the process group's ranks, or (dp, sp, tp) when
    sp > 1. tp defaults to the largest power of two <= min(n_devices, 8)
    that divides n_devices. The mesh spans the whole group: n_devices, if
    given, must be its world size. Its device type is that of the tensors
    the group was joined for (init_process_group's device; else nccl: cuda,
    gloo: cpu)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "sharding.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"n_devices {n} must equal the world size {world}")
    if tp is None:
        tp = 1
        while tp * 2 <= min(n, 8) and n % (tp * 2) == 0:
            tp *= 2
    if n % (tp * sp) != 0:
        raise ValueError(f"n_devices {n} not divisible by tp*sp {tp * sp}")
    dp = n // (tp * sp)
    device_type = _GROUP_DEVICE[0] or ("cuda" if "nccl" in dist.get_backend() else "cpu")
    if sp == 1:
        return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))
    return init_device_mesh(device_type, (dp, sp, tp), mesh_dim_names=("dp", "sp", "tp"))


def _place(x: torch.Tensor, mesh: DeviceMesh, spec: tuple) -> DTensor:
    """A copy of the full tensor `x` as a DTensor on `mesh`: `spec` names,
    per tensor axis, the mesh axis it is split over (or None), as a JAX
    PartitionSpec does; this rank keeps its even chunk, on x's device when
    that is of the mesh's device type (else on the mesh's current device).
    No collective."""
    placements, local = [], x
    for i, name in enumerate(mesh.mesh_dim_names):
        if name not in spec:
            placements.append(Replicate())
            continue
        axis, n = spec.index(name), mesh.size(i)
        if local.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split over "
                             f"{name} = {n}")
        local = local.chunk(n, dim=axis)[mesh.get_local_rank(name)]
        placements.append(Shard(axis))
    if x.device.type == mesh.device_type:
        dev = x.device
    elif mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    local = local.to(device=dev, copy=True, memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def shard_batch(batch: dict, mesh: DeviceMesh, sp: bool = False) -> dict:
    """Place a training batch on the mesh: batch axis on "dp", and, when
    sp=True on a mesh with an "sp" axis, the time axis on "sp".
    embeds / frames / targets / mask are [B, T, ...]; other keys are
    replicated."""
    if sp and "sp" not in mesh.mesh_dim_names:
        raise ValueError("sp=True needs a mesh built with make_mesh(sp=...)")
    t_axis = "sp" if sp else None
    specs = {"embeds": ("dp", t_axis, None), "frames": ("dp", t_axis, None),
             "targets": ("dp", t_axis), "mask": ("dp", t_axis)}
    return {k: _place(v, mesh, specs.get(k, ())) for k, v in batch.items()}


def talker_param_pspecs(config: Qwen3TTSConfig) -> dict:
    """Spec tree matching the unfused talker tree (unfuse_qkv_gateup): per
    leaf, the mesh axis name of each tensor axis, () for replicated. Each
    tp split of q / k / v and gate / up lands on head / section boundaries.
    (JAX's unfused=False layout, the fused rows split across sections, has
    no counterpart: the explicit collectives need whole heads per rank.)"""
    rep = ()
    col = {"w": (None, "tp", None)}
    return {
        "text_embedding": {"w": rep},
        "codec_embedding": {"w": rep},
        "text_projection": {"fc1": {"w": rep, "b": rep}, "fc2": {"w": rep, "b": rep}},
        "codec_head": {"w": rep},
        "norm": {"w": rep},
        "layers": {
            "input_layernorm": {"w": rep},
            "post_attention_layernorm": {"w": rep},
            "q_norm": {"w": rep},
            "k_norm": {"w": rep},
            "qkv_proj": {"q": dict(col), "k": dict(col), "v": dict(col)},
            "o_proj": {"w": (None, None, "tp")},
            "gateup_proj": {"gate": dict(col), "up": dict(col)},
            "down_proj": {"w": (None, None, "tp")},
        },
    }


def unfuse_qkv_gateup(params: dict, config: Qwen3TTSConfig) -> dict:
    """Split the fused qkv / gateup stacked weights into per-section
    entries (the tensor-parallel layout layer_qkv / swiglu accept). Dense
    entries only: a quantized or megakernel tree raises ValueError.
    Returns a new tree sharing every other leaf (the sections are
    views)."""
    lay = params["layers"]
    if "kernel" in params:
        raise ValueError("unfuse_qkv_gateup expects a dense tree; a megakernel tree "
                         "(params['kernel']) runs on one device")
    if "q" in lay["qkv_proj"]:
        return params
    if "w" not in lay["qkv_proj"] or "w" not in lay["gateup_proj"]:
        raise ValueError("unfuse_qkv_gateup expects dense fused entries; quantized trees "
                         "must be dequantized before tensor-parallel sharding")
    hd = config.head_dim
    nq = config.num_attention_heads * hd
    nkv = config.num_key_value_heads * hd
    inter = config.intermediate_size
    qkv = lay["qkv_proj"]["w"]  # [L, nq + 2 nkv, H]
    gu = lay["gateup_proj"]["w"]  # [L, 2I, H]
    new_lay = dict(lay)
    new_lay["qkv_proj"] = {"q": {"w": qkv[:, :nq]}, "k": {"w": qkv[:, nq:nq + nkv]},
                           "v": {"w": qkv[:, nq + nkv:]}}
    new_lay["gateup_proj"] = {"gate": {"w": gu[:, :inter]}, "up": {"w": gu[:, inter:]}}
    return dict(params, layers=new_lay)


def shard_params(params: dict, mesh: DeviceMesh, pspecs: dict | None = None,
                 config: Qwen3TTSConfig | None = None) -> dict:
    """A copy of a talker tree placed on the mesh in the tp layout (every
    leaf a DTensor). Dense fused trees are unfused first, so the returned
    tree has per-section q / k / v and gate / up entries."""
    if pspecs is None:
        if config is None:
            raise ValueError("shard_params needs pspecs or config")
        params = unfuse_qkv_gateup(params, config)
        pspecs = talker_param_pspecs(config)

    def place(tree, specs):
        return {k: place(v, specs[k]) if isinstance(v, dict) else _place(v, mesh, specs[k])
                for k, v in tree.items()}

    return place(params, pspecs)


def validate_tp_divisibility(config: Qwen3TTSConfig, tp: int) -> None:
    if config.num_key_value_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must divide num_key_value_heads={config.num_key_value_heads}")
    if config.intermediate_size % tp != 0:
        raise ValueError(
            f"tp={tp} must divide intermediate_size={config.intermediate_size}")


def local_tensor(x):
    """The rank's shard of a DTensor (the same storage), else x."""
    return x.to_local() if isinstance(x, DTensor) else x


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def is_placed(tree: dict) -> bool:
    """True for a tree placed on a mesh (shard_params places every leaf)."""
    return isinstance(_first_leaf(tree), DTensor)


# id(first leaf) -> (weak reference to it, the tree's keys, Parallel, local
# tree); an entry goes when its leaf does
_LOCAL: dict = {}


def local_params(tree: dict) -> tuple["Parallel", dict]:
    """(the collectives of an inference call on `tree`, the tree of this
    rank's local tensors). An unplaced tree comes back as it is with the
    one-process Parallel. A placed one (shard_params) gives the tp group
    when a leaf is sharded on "tp" and its leaves' local shards (the same
    storage), cached per tree: the talker functions call this on every
    call. A tree that mixes placed and plain leaves raises."""
    first = _first_leaf(tree)
    if not isinstance(first, DTensor):
        return SINGLE, tree
    keys = tuple(tree)
    entry = _LOCAL.get(id(first))
    if entry is not None and entry[0]() is first and entry[1] == keys:
        return entry[2], entry[3]
    leaves = []

    def local(node):
        if isinstance(node, dict):
            return {k: local(v) for k, v in node.items()}
        if not isinstance(node, DTensor):
            raise ValueError("a placed tree must have every leaf placed (shard_params)")
        leaves.append(node)
        return node.to_local()

    with torch.no_grad():  # no autograd edge back to the DTensors
        out = local(tree)
    par = Parallel.of_params(leaves)
    _LOCAL[id(first)] = (weakref.ref(first, lambda _r, k=id(first): _LOCAL.pop(k, None)),
                         keys, par, out)
    return par, out


def gather_rows(x) -> torch.Tensor:
    """The full tensor of a DTensor sharded on its axis 0 (rows on "dp"),
    on the host. Over gloo each rank's rows are copied to the CPU and
    gathered there, since gloo cannot all-gather CUDA tensors; over nccl
    on the card. A plain tensor comes back on the host as it is."""
    if not isinstance(x, DTensor):
        return x.cpu()
    if any(isinstance(p, Shard) and p.dim != 0 for p in x.placements):
        raise ValueError("gather_rows gathers a tensor sharded on axis 0")
    mesh = x.device_mesh
    if dist.get_backend(mesh.get_group(0)) != "gloo":
        return x.full_tensor().cpu()
    local = x.to_local().detach().cpu().contiguous()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            group = mesh.get_group(i)
            parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, local, group=group)
            local = torch.cat(parts)
    return local


# ---------------------------------------------------------------------------
# The step's collectives
# ---------------------------------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce over tp backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: all-reduce over tp forward, identity backward (an
    all-reduce there too would scale replicated leaves' gradients by tp)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather over sp along `dim`; the backward is a reduce-scatter
    (written as an all-reduce and this rank's rows: gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None


class Parallel:
    """The collectives of one train step or one inference call, from where
    its arguments lie. Parallel() is one process: every method is the
    identity."""

    reduces = 0  # reduce() calls that all-reduced, over every instance

    def __init__(self, tp=None, sp=None, batch_groups: tuple = ()):
        self.tp, self.sp, self.batch_groups = tp, sp, batch_groups
        self.tp_size = 1 if tp is None else dist.get_world_size(tp)
        self.sp_size = 1 if sp is None else dist.get_world_size(sp)
        self.sp_rank = 0 if sp is None else dist.get_rank(sp)

    @classmethod
    def of(cls, leaves: list, batch: dict) -> "Parallel":
        """tp where a param leaf is sharded on "tp"; the batch groups are the
        mesh axes batch["embeds"] is sharded on, sp among them when its
        time axis is."""
        placed = [x for x in (*leaves, *batch.values()) if isinstance(x, DTensor)]
        if not placed:
            return cls()
        mesh = placed[0].device_mesh
        names = mesh.mesh_dim_names

        def axis(x, name):  # the tensor axis x is sharded on along mesh axis `name`
            if not isinstance(x, DTensor) or name not in names:
                return None
            p = x.placements[names.index(name)]
            return p.dim if isinstance(p, Shard) else None

        emb = batch["embeds"]
        if axis(emb, "tp") is not None:
            raise ValueError("the batch is sharded on dp (and sp), never on tp")
        if axis(emb, "sp") not in (None, 1):
            raise ValueError("sp shards the batch's time axis (axis 1)")
        tp = mesh.get_group("tp") if any(axis(x, "tp") is not None for x in leaves) else None
        dims = [n for n in names if n != "tp" and axis(emb, n) is not None]
        return cls(tp, mesh.get_group("sp") if "sp" in dims else None,
                   tuple(mesh.get_group(n) for n in dims))

    @classmethod
    def of_params(cls, tree) -> "Parallel":
        """tp where a leaf of a param tree (a nested dict, or a list of its
        leaves) is sharded on "tp": an inference call has no batch to read."""
        leaves = tree if isinstance(tree, list) else _leaves(tree)
        placed = [x for x in leaves if isinstance(x, DTensor)]
        if not placed:
            return cls()
        mesh = placed[0].device_mesh
        names = mesh.mesh_dim_names
        if "tp" not in names:
            return cls()
        i = names.index("tp")
        if any(isinstance(x.placements[i], Shard) for x in placed):
            return cls(mesh.get_group("tp"))
        return cls()

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Megatron's g in inference (no autograd): this rank's partial sums
        y of a row-parallel product (o_proj, down_proj: no bias) summed over
        tp in fp32, then cast back to y's dtype; at tp = 1 that is y bit for
        bit."""
        if self.tp is None:
            return y
        s = y.to(torch.float32, memory_format=torch.contiguous_format)
        if s is y:
            s = y.clone()
        dist.all_reduce(s, group=self.tp)
        Parallel.reduces += 1
        return s.to(y.dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else _CopyToTP.apply(x, self.tp)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.tp is None else _ReduceFromTP.apply(y, self.tp)

    def gather_seq(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.sp is None else _GatherSeq.apply(x, self.sp, dim)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the batch's sharded axes (no gradient)."""
        x = x.detach().clone()
        for group in self.batch_groups:
            dist.all_reduce(x, group=group)
        return x

    def sync_grads(self, grads: list) -> None:
        """Each rank's gradient of its share of the loss (local sum over the
        global mask sum), summed in place over the batch's sharded axes."""
        for g in grads:
            for group in self.batch_groups:
                dist.all_reduce(g, group=group)


SINGLE = Parallel()  # one process: every collective is the identity
