"""Roofline terms of a step at the card's datasheet peaks, the port of
``repro/launch/roofline.py``.

Two terms per (arch x shape x mesh), in seconds a device:

  compute = sum over dtypes of FLOPs / peak   [989e12 for bf16 and fp16
            on the tensor cores, 67e12 for float32 and every other type]
  memory  = bytes / 3.35e12         [HBM3]

The reference reads FLOPs and bytes from XLA's cost analysis and parses
collective and fused bytes out of the HLO text. The port has no
compiler in between: ``OpCounter`` (a ``TorchDispatchMode``) watches
every aten op of one step run on ``meta`` tensors and records

- its FLOPs (``torch.utils.flop_counter``'s formulas: matmuls,
  convolutions, attention), by the dtype of its first floating operand
  (``flops_by_dtype``);
- its operand and output bytes (``hbm_bytes``, every op unfused: what an
  eager run moves at most);
- the same bytes of the heavy ops only (``hbm_bytes_fused``: matmuls,
  convolutions, gathers, scatters and index ops, sorts, reductions and
  in-place slice writes, as ``fused_bytes`` picks HLO ops; elementwise
  chains are taken to fuse into them);
- the hand kernels' own FLOPs (by the dtype they work in) and bytes,
  which their wrappers charge on meta (``kernels/meta.py``) in place of
  their plain versions';
- the peak of the step's live intermediates: the bytes of every storage
  an op made, from its making until the last tensor on it dies
  (arguments excluded); with ``trace``, the live bytes after every op.

``CollCounter`` (another dispatch mode) counts the collectives of one
step run on meta DTensors on the mesh (the dry run's forward cells):
the output bytes of every functional collective a rank issues, by the
reference's kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``), as the reference sums the
output shapes of the HLO's collectives. ``t_collective`` takes them at
the NVLink rate; a cell with no count (a train or GNN cell, whose mesh
run is a later slice's) has ``coll_bytes`` None (never 0), and
``bottleneck`` then picks between compute and memory.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     peak_flops)

# ops whose operand and output bytes count as HBM traffic once the
# elementwise chains around them fuse (the reference's _HEAVY_OPS)
_HEAVY = {
    # products and convolutions
    "mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv", "addmv",
    "convolution", "convolution_backward", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    # gathers, scatters and index ops
    "embedding", "embedding_dense_backward", "index_select", "gather",
    "scatter", "scatter_add", "scatter_add_", "scatter_", "scatter_reduce",
    "index_add", "index_add_", "index_put", "index_put_", "index",
    "_index_put_impl_", "take", "masked_select", "nonzero",
    # sorts
    "sort", "topk", "argsort", "searchsorted", "kthvalue",
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "var_mean", "var", "std", "norm",
    "linalg_vector_norm", "cumsum", "prod", "any", "all",
    "native_layer_norm", "native_layer_norm_backward",
    # in-place slice writes (dynamic-update-slice)
    "copy_", "slice_scatter", "select_scatter",
}
# ops that move no bytes: allocation without a write
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "resize_"}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


#: the reference's collective kinds, by the functional collectives' names
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
_COLL_OPS = {"all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all"}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


class CollCounter(TorchDispatchMode):
    """The bytes of every collective the ops inside it issue, by kind
    (``COLL_KINDS``): each functional collective's output bytes on this
    rank. A DTensor op is let through first (``NotImplemented``), so the
    collectives it lowers to are seen on the local tensors."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.bytes = {k: 0 for k in COLL_KINDS}
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLL_NAMESPACES:
            name = func._overloadpacket.__name__
            if name in _COLL_OPS:
                kind = _COLL_OPS[name]
                self.bytes[kind] += _bytes(_tensors(out))
                self.calls += 1
            elif name not in ("wait_tensor", "_wrap_tensor_autograd"):
                raise NotImplementedError(f"CollCounter: unknown "
                                          f"collective {func}")
        return out


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _operand_dtype(ts: list[torch.Tensor]) -> str:
    """The dtype an op computes in: its first floating operand's."""
    t = next((t for t in ts if t.is_floating_point()), ts[0] if ts else None)
    return "float32" if t is None else dtype_name(t.dtype)


class OpCounter(TorchDispatchMode):
    """FLOPs, bytes and the live-intermediate peak of every op run inside
    it (see the module docstring). ``resident`` are tensors whose
    storages are not intermediates (the step's arguments)."""

    def __init__(self, resident=(), trace: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.flops_by_dtype: collections.Counter = collections.Counter()
        self.hbm_bytes = 0.0
        self.hbm_bytes_fused = 0.0
        self.by_op: collections.Counter = collections.Counter()
        self.kernels: dict[str, dict] = {}
        self._resident = {t.untyped_storage()._cdata
                          for t in _tensors(resident)}
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        # with ``trace``: (op name, live bytes after it) for every op
        self.trace: list | None = [] if trace else None

    # -- kernel charges (kernels/meta.py) ------------------------------------

    def charge(self, name: str, flops: float, nbytes: float,
               dtype: torch.dtype) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.flops_by_dtype[dtype_name(dtype)] += flops
        self.hbm_bytes += nbytes
        self.hbm_bytes_fused += nbytes

    # -- live storages --------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._resident or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in self._flop_registry:
            # a composite op (einsum, softmax under inference mode) is
            # counted by the ops it decomposes into, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = packet.__name__
        outs = _tensors(out)
        if packet in self._flop_registry:
            fl = float(self._flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
            self.flops += fl
            self.flops_by_dtype[_operand_dtype(_tensors(args))] += fl
        if not func.is_view and name not in _NO_BYTES:
            moved = _bytes(_tensors(args) + _tensors(kwargs) + outs)
            self.hbm_bytes += moved
            if name in _HEAVY:
                self.hbm_bytes_fused += moved
            self.by_op[name] += moved
        for t in outs:
            self._track(t)
        if self.trace is not None:
            self.trace.append((name, self.live_bytes))
        return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float | None           # per-device FLOPs (the ideal partition)
    hbm_bytes: float | None       # per-device bytes, every op unfused
    coll_bytes: dict | None       # per-device bytes by kind; None: not run
    per_device_mem: int           # argument shards + reckoned temporaries
    model_flops: float = 0.0      # 6*N*D (or family analogue)
    hbm_bytes_fused: float | None = None  # heavy ops' bytes only
    # per-device FLOPs by dtype name; None: all of ``flops`` in bf16
    flops_by_dtype: dict | None = None

    @property
    def t_compute(self) -> float | None:
        """Each dtype's FLOPs at its datasheet peak (``mesh.peak_flops``)."""
        if self.flops is None:
            return None
        if self.flops_by_dtype is None:
            return self.flops / PEAK_FLOPS_BF16
        return sum(f / peak_flops(d) for d, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float | None:
        """The heavy ops' bytes at the HBM rate (headline); the unfused
        term is ``t_memory_raw``."""
        b = self.hbm_bytes_fused or self.hbm_bytes
        return None if b is None else b / HBM_BW

    @property
    def t_memory_raw(self) -> float | None:
        return None if self.hbm_bytes is None else self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float | None:
        if self.coll_bytes is None:
            return None
        return sum(self.coll_bytes.values()) / NVLINK_BW

    def _terms(self) -> dict:
        return {k: v for k, v in (("compute", self.t_compute),
                                  ("memory", self.t_memory),
                                  ("collective", self.t_collective))
                if v is not None}

    @property
    def bottleneck(self) -> str | None:
        terms = self._terms()
        return max(terms, key=terms.get) if terms else None

    @property
    def roofline_fraction(self) -> float | None:
        """useful-compute time (the model's FLOPs at the bf16 peak) /
        dominant-term time (1.0 = at roofline)."""
        terms = self._terms()
        if not terms:
            return None
        t_dom = max(terms.values())
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return t_useful / t_dom if t_dom > 0 else 0.0

    @property
    def flops_efficiency(self) -> float | None:
        """MODEL_FLOPS / (FLOPs x chips): the useful share of compute."""
        if self.flops is None:
            return None
        tot = self.flops * self.chips
        return self.model_flops / tot if tot else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "per_device_mem": self.per_device_mem,
            "model_flops": self.model_flops,
            "hbm_bytes_fused": self.hbm_bytes_fused,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_memory_raw": self.t_memory_raw,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "flops_efficiency": self.flops_efficiency,
        }


def model_flops_for(arch_id: str, shape_name: str, arch=None,
                    shape=None) -> float:
    """Useful FLOPs per step: 6·N·D for LM training (N = active params),
    2·N·D for inference; family analogues elsewhere. ``arch`` and
    ``shape`` override the registered ones (a cut cell)."""
    from repro_torch.configs.base import get_config

    arch = get_config(arch_id) if arch is None else arch
    shape = arch.shape(shape_name) if shape is None else shape
    if arch.family == "lm":
        n_active = arch.model.n_active_params()
        if shape.kind == "train":
            tokens = shape["global_batch"] * shape["seq_len"]
            return 6.0 * n_active * tokens
        if shape.kind == "prefill":
            tokens = shape["global_batch"] * shape["seq_len"]
            return 2.0 * n_active * tokens
        tokens = shape["global_batch"]            # one token per stream
        return 2.0 * n_active * tokens
    if arch.family == "encoder":
        n = arch.model.n_params()
        tokens = shape["global_batch"] * min(shape["seq_len"],
                                             arch.model.max_len)
        mult = {"train": 6.0, "serve": 2.0}[shape.kind]
        if shape.name.startswith("dpo"):
            mult = 6.0 * 2 + 2.0 * 2          # 2 policy fwd+bwd, 2 ref fwd
        return mult * n * tokens
    if arch.family == "vit_parser":
        cfg = arch.model
        n_enc = cfg.enc_layers * (4 * cfg.enc_d_model ** 2
                                  + 2 * cfg.enc_d_model * cfg.enc_d_ff)
        n_dec = cfg.dec_layers * (8 * cfg.dec_d_model ** 2
                                  + 2 * cfg.dec_d_model * cfg.dec_d_ff)
        b = shape["global_batch"]
        t = shape.dims.get("dec_len", 0)
        mult = 6.0 if shape.kind == "train" else 2.0
        enc_toks = b * cfg.n_patches
        dec_toks = b * (t if shape.kind == "train" else 1)
        if shape.name == "parse_encode":
            dec_toks = 0
        if shape.name == "parse_decode":
            enc_toks = 0              # decode cell runs the decoder only
        return mult * (n_enc * enc_toks + n_dec * dec_toks)
    if arch.family == "gnn":
        from repro_torch.launch.specs import _gnn_dims
        cfg = arch.model
        n, e = _gnn_dims(shape)
        c = cfg.d_hidden
        so2 = sum(2 * ((cfg.l_max - m + 1) * 2 * c) * ((cfg.l_max - m + 1) * c)
                  * (1 if m == 0 else 2) for m in range(cfg.m_max + 1))
        wig = sum((2 * l + 1) ** 2 * 2 for l in range(cfg.l_max + 1))
        per_edge = so2 + 2 * wig * 2 * c          # conv + rotate in/out
        per_node = 2 * (cfg.l_max + 1) ** 2 * c * c * 2 * 2  # FFN
        fwd = cfg.n_layers * (e * per_edge + n * per_node)
        return 3.0 * fwd                           # fwd + bwd
    if arch.family == "recsys":
        cfg = arch.model
        if shape.name == "retrieval_cand":
            return 2.0 * shape["n_candidates"] * cfg.embed_dim
        b = shape["batch"]
        if cfg.kind == "dlrm":
            f = cfg.n_sparse + 1
            d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
            dims_chain = [(cfg.n_dense,) + cfg.bot_mlp,
                          (d_int,) + cfg.top_mlp]
            inter = f * f * cfg.embed_dim
        elif cfg.kind == "deepfm":
            dims_chain = [(cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,)]
            inter = cfg.n_sparse * cfg.embed_dim * 2
        elif cfg.kind == "autoint":
            inter = cfg.n_attn_layers * (
                3 * cfg.n_sparse * cfg.embed_dim * cfg.d_attn
                + 2 * cfg.n_sparse ** 2 * cfg.d_attn)
            dims_chain = [(cfg.n_sparse * cfg.d_attn, 1)]
        else:  # dien
            inter = cfg.seq_len * 6 * (2 * cfg.embed_dim + cfg.gru_dim) \
                * cfg.gru_dim * 2
            dims_chain = [(cfg.gru_dim + 2 * cfg.embed_dim,) + cfg.mlp + (1,)]
        mlp_fl = sum(2 * a * bb for chain in dims_chain
                     for a, bb in zip(chain[:-1], chain[1:]))
        lookup = cfg.n_sparse * cfg.embed_dim
        mult = 3.0 if shape.kind == "train" else 1.0
        return mult * b * 2 * (mlp_fl / 2 + inter + lookup)
    return 0.0


def _ms(x) -> str:
    return "—" if x is None else f"{x * 1e3:.2f}"


def summarize(records: list[dict]) -> str:
    """A Markdown table of dry-run records."""
    hdr = ("| arch | shape | mesh | chips | t_comp (ms) | t_mem (ms) | "
           "t_coll (ms) | bottleneck | GFLOPs | model/counted | "
           "roofline frac | mem GB | fits |")
    sep = "|" + "---|" * 13
    rows = [hdr, sep]
    for r in records:
        fl = "—" if r["flops"] is None else f"{r['flops'] / 1e9:.0f}"
        eff = ("—" if r["flops_efficiency"] is None
               else f"{r['flops_efficiency'] * 100:.0f}%")
        frac = ("—" if r["roofline_fraction"] is None
                else f"{r['roofline_fraction'] * 100:.1f}%")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} | "
            f"{_ms(r['t_compute'])} | {_ms(r['t_memory'])} | "
            f"{_ms(r['t_collective'])} | {r['bottleneck']} | {fl} | {eff} | "
            f"{frac} | {r.get('mem_gb', '—')} | {r.get('fits_hbm', '—')} |")
    return "\n".join(rows)
