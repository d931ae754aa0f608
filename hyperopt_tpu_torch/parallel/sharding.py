"""Device meshes and sharded TPE scoring (the dp×sp compute plane).

Reference parity: ``hyperopt_tpu/parallel/sharding.py``.  TPE's scaling
axis is the trial history: the above mixture grows with every trial, so
the O(candidates × components) scoring is what a mesh divides.  Candidates
shard over ``dp``; mixture components shard over ``sp``, each shard
reducing its own components to a logsumexp partial that a max and a sum
combine (the blockwise-softmax pattern of ring attention, minus the ring).

The reference is one SPMD program that XLA partitions.  Here one Python
process drives its mesh slots explicitly:

- :class:`DeviceMesh` is a ``dp × sp`` grid of ``torch.device`` slots.  A
  slot may repeat a device (the counterpart of the reference's virtual
  CPU devices: the tests lay 8 slots on ``cpu``, the card's check 2 or 4
  on ``cuda:0``).  Each slot owns a CUDA stream on its device (none on
  the CPU).  One device, or ``off``, is the degenerate mesh:
  :func:`resolve_mesh` returns None and a suggest runs the single-device
  program bit for bit.
- Replicated means on the lead slot: the γ-split, fits, draw and argmax
  run once, on the first slot's device, on the caller's stream.  Only the
  scoring fans out (:func:`run_on_slots`): each slot gets its ``dp`` block
  of candidates and its ``sp`` block of components (O(history + C/dp)
  bytes), computes on its own stream and records an event; the lead
  stream waits on every slot's event, gathers the partials and combines
  them.  Every tensor that one stream made and another reads is marked
  with ``record_stream``, so the caching allocator never hands it out
  while the reader may still run.
- The pair scorer (:func:`make_sharded_pair_score_batched`) splits the
  two regions of the component axis separately: the below block and the
  above block are each padded to a multiple of ``sp`` with at least one
  column per shard, with ``(0, 0, NEG_BIG)`` columns, and shard ``j``
  holds block ``j`` of each.  The reference shards the concatenated axis,
  where a shard may hold one region only; the pair-score kernel needs both
  regions in every launch (``ops/pair_kernel.py``).  A region of only
  padding gives a partial near NEG_BIG, which adds exactly 0 to the
  combined sum.  Each shard's step is the pair-score kernel's partials
  launch (``ops.pair_kernel.pair_lse_partials``) on the card, its plain
  version on the CPU.  The combine is the reference's ``pmax``/``psum``:
  the MAX of the shards' partials, the SUM of ``exp(partial − max)``, then
  ``max + log(sum)``.  The layout changes the float order of the sums
  only, within the near-tie contract of the reference's
  (``hyperopt_tpu/ops/pallas_fused.py:52-55``).
- Across processes (:func:`hyperopt_tpu_torch.parallel.distributed
  .global_mesh`) a slot belongs to one rank.  Each rank computes its own
  slots; a ``dp`` row whose ``sp`` shards lie on several ranks is combined
  with ``torch.distributed.all_reduce`` over one subgroup per row (MAX,
  then SUM), and the rows are then shared so every rank returns the whole
  result.  Every rank calls a scorer with the same inputs, as in the
  reference (``hyperopt_tpu/parallel/distributed.py``).

Every scorer takes and returns torch tensors on the lead slot's device.
"""

from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gmm import _cdf, _log_cdf_arg
from ..ops.score import NEG_BIG

_SQRT_2PI = 2.5066282746310002
EPS = 1e-12

# (mesh identity, slot) -> that slot's CUDA stream; dropped by the device
# recovery's reset (drop_slot_streams)
_slot_streams = {}
# mesh identity -> {row: weak reference to its process group or None,
# "all": the same}: weak, so the groups (and the store they hold) die with
# the world that ``destroy_process_group`` ends, and are made anew in the next
_groups = {}


def local_devices():
    """This process's CUDA devices; raises when there is none (a mesh on
    the CPU names its devices: ``DeviceMesh(devices=["cpu"] * 8)``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a mesh runs on the local CUDA devices and none is available; "
            "pass devices= (for example ['cpu'] * 8) to build one on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_shape(n: int):
    """``(n // sp, sp)`` with the largest power-of-two ``sp`` <= √n + 1
    that divides ``n``: history sharding is the scaling axis, candidate
    sharding the throughput axis (the reference's heuristic)."""
    sp = 1
    while sp * 2 <= int(np.sqrt(n)) + 1 and n % (sp * 2) == 0:
        sp *= 2
    return n // sp, sp


def default_mesh(axis_names=("dp", "sp"), shape=None, devices=None):
    """A :class:`DeviceMesh` over ``devices`` (default: the local CUDA
    devices) in ``shape`` (default: :func:`default_shape`)."""
    if tuple(axis_names) != ("dp", "sp"):
        raise ValueError(f"mesh axes are ('dp', 'sp'), got {axis_names!r}")
    devices = local_devices() if devices is None else list(devices)
    return DeviceMesh(devices=devices,
                      shape=default_shape(len(devices)) if shape is None else shape)


class DeviceMesh:
    """A ``dp`` (candidates, batched studies) × ``sp`` (Parzen components)
    grid of device slots, the mesh execution mode of the suggest plane.

    - :meth:`auto` builds a mesh over every local CUDA device with the
      :func:`default_shape` heuristic;
    - :meth:`from_spec` parses the service flag grammar (``auto`` |
      ``off`` | ``"DPxSP"`` | ``"DP,SP"``);
    - :attr:`grid` is the ``dp`` rows of ``sp`` slot devices, or None for
      the DEGENERATE mesh (one device with no shape, or a 1×1 shape): a
      suggest then runs the single-device program bit for bit;
    - :meth:`topology` is the JSON-able identity (backend, slot count,
      shape) that the compile ledger's fingerprint and ``/v1/status``
      carry, so a program recorded under one topology never replays onto
      another.

    ``devices`` may repeat a device (slots sharing one card or the CPU).
    ``ranks`` (one per device, process-major; :func:`~hyperopt_tpu_torch
    .parallel.distributed.global_mesh`) says which process owns each slot;
    None means this process owns all.  Equal and hashable by devices,
    shape and ranks, so it can sit in a request's statics.
    """

    __slots__ = ("grid", "dp", "sp", "devices", "ranks")

    def __init__(self, devices=None, shape=None, ranks=None):
        devices = local_devices() if devices is None else [_as_device(d) for d in devices]
        if not devices:
            raise ValueError("DeviceMesh needs at least one device")
        self.devices = tuple(devices)
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        if self.ranks is not None and len(self.ranks) != len(self.devices):
            raise ValueError(f"{len(self.ranks)} ranks for {len(self.devices)} devices")
        n = len(devices)
        if n == 1 and (shape is None or tuple(shape) == (1, 1)):
            self.grid = None
            self.dp, self.sp = 1, 1
            return
        dp, sp = default_shape(n) if shape is None else (int(shape[0]), int(shape[1]))
        if dp < 1 or sp < 1:
            raise ValueError(f"mesh axes must be >= 1: {shape!r}")
        if dp * sp != n:
            raise ValueError(
                f"mesh shape dp={dp} x sp={sp} needs {dp * sp} devices; "
                f"{n} device(s) given"
            )
        self.dp, self.sp = dp, sp
        self.grid = tuple(self.devices[i * sp:(i + 1) * sp] for i in range(dp))

    # -- constructors --------------------------------------------------
    @classmethod
    def auto(cls, devices=None):
        """A mesh over every local CUDA device (degenerate on one card)."""
        return cls(devices=devices)

    @classmethod
    def from_spec(cls, spec, devices=None):
        """Parse the ``--mesh`` flag grammar.

        ``None``/``"off"`` → None (the single-device dispatch), ``"auto"``
        → :meth:`auto`, ``"DPxSP"`` or ``"DP,SP"`` → that shape over
        ``devices`` (default: the local CUDA devices; ValueError when the
        product does not match their count: a mesh never runs on a subset
        of the cards).  A DeviceMesh passes through."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        token = str(spec).strip().lower()
        if token in ("off", "none", ""):
            return None
        if token == "auto":
            return cls.auto(devices=devices)
        for sep in ("x", ","):
            if sep in token:
                parts = token.split(sep)
                if len(parts) != 2:
                    break
                try:
                    dp, sp = int(parts[0]), int(parts[1])
                except ValueError:
                    break
                if dp < 1 or sp < 1:
                    raise ValueError(f"mesh axes must be >= 1: {spec!r}")
                devs = local_devices() if devices is None else list(devices)
                if dp * sp != len(devs):
                    # idle cards would contradict every topology identity
                    # stamped from this process (ledger, /v1/status)
                    raise ValueError(
                        f"mesh spec {spec!r} covers {dp * sp} device(s) "
                        f"but {len(devs)} are local; use an exact shape or 'auto'"
                    )
                return cls(devices=devs, shape=(dp, sp))
        raise ValueError(
            f"bad mesh spec {spec!r}: expected 'auto', 'off', or 'DPxSP' "
            f"(e.g. '4x2' or '4,2')"
        )

    # -- identity ------------------------------------------------------
    @property
    def n_devices(self) -> int:
        """Slots in the mesh (a repeated device counts once per slot)."""
        return len(self.devices)

    @property
    def shape_str(self) -> str:
        return f"{self.dp}x{self.sp}"

    def device_labels(self):
        """One ``'<type>:<index>'`` label per slot, in slot order; a
        device repeated over slots repeats its label."""
        return [f"{d.type}:{d.index or 0}" for d in self.devices]

    def topology(self) -> dict:
        """The JSON-able topology identity (the compile-ledger fingerprint's
        part)."""
        return {
            "backend": self.devices[0].type,
            "device_count": self.n_devices,
            "mesh": self.shape_str if self.grid is not None else "off",
        }

    def _key(self):
        return (self.devices, self.dp, self.sp, self.ranks)

    def __eq__(self, other):
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        mode = "degenerate" if self.grid is None else self.shape_str
        return f"DeviceMesh({mode}, n_devices={self.n_devices})"

    # -- slots ---------------------------------------------------------
    def owner(self, i: int, j: int) -> int:
        """The rank that owns slot ``(i, j)``."""
        return 0 if self.ranks is None else self.ranks[i * self.sp + j]

    def is_local(self, i: int, j: int) -> bool:
        return self.ranks is None or self.owner(i, j) == _rank()

    def local_slots(self):
        return [(i, j) for i in range(self.dp) for j in range(self.sp) if self.is_local(i, j)]

    def row_slot(self, i: int):
        """Row ``i``'s first slot owned by this process, or None."""
        return next(((i, j) for j in range(self.sp) if self.is_local(i, j)), None)

    @property
    def lead_device(self) -> torch.device:
        """Where the replicated stages run: this process's first slot."""
        if self.grid is None:
            return self.devices[0]
        i, j = self.local_slots()[0]
        return self.grid[i][j]

    def slot_stream(self, i: int, j: int):
        """Slot ``(i, j)``'s own CUDA stream (made at first use), or None
        on the CPU."""
        dev = self.grid[i][j]
        if dev.type != "cuda":
            return None
        key = (self._key(), i, j)
        stream = _slot_streams.get(key)
        if stream is None:
            stream = _slot_streams.setdefault(key, torch.cuda.Stream(device=dev))
        return stream

    def row_group(self, i: int):
        """The process group of row ``i``'s ranks, or None when one
        process owns the whole row."""
        return self._process_groups()[i]

    def all_group(self):
        """The group of every rank in the mesh, or None for one process."""
        return self._process_groups()["all"]

    def _process_groups(self):
        # new_group is collective: every rank makes every group, in one
        # order, at its first sharded call in each world (the SPMD contract)
        refs = _groups.get(self._key(), {})
        groups = {k: r if r is None else r() for k, r in refs.items()}
        if not refs or any(r is not None and groups[k] is None for k, r in refs.items()):
            groups = {}
            ranks = [self.owner(i, j) for i in range(self.dp) for j in range(self.sp)]
            multi = len(set(ranks)) > 1
            for i in range(self.dp):
                row = sorted({self.owner(i, j) for j in range(self.sp)})
                groups[i] = torch.distributed.new_group(row) if len(row) > 1 else None
            groups["all"] = torch.distributed.new_group(sorted(set(ranks))) if multi else None
            _groups[self._key()] = {k: g if g is None else weakref.ref(g)
                                    for k, g in groups.items()}
        return groups


def drop_slot_streams():
    """Forget every mesh slot's stream (the device recovery's reset)."""
    _slot_streams.clear()


def resolve_mesh(mesh):
    """Every accepted ``mesh=`` form as what the suggest plane dispatches
    on: a non-degenerate :class:`DeviceMesh`, or None for the
    single-device program.  Accepts None, a DeviceMesh, or a spec string
    (``auto``/``off``/``DPxSP`` over the local CUDA devices)."""
    if mesh is None:
        return None
    dm = mesh if isinstance(mesh, DeviceMesh) else DeviceMesh.from_spec(mesh)
    return None if dm is None or dm.grid is None else dm


def resolve_mesh_device(mesh, device):
    """``(mesh, device)`` of one entry point's ``mesh=`` and ``device=``:
    the mesh resolved (None when absent or degenerate) and the device the
    work runs on, the mesh's lead slot, which ``device`` may only restate.
    A spec string with a CPU ``device`` resolves over the CPU (``"auto"``
    is then degenerate); a degenerate mesh names its one device."""
    if isinstance(mesh, str) and device is not None and torch.device(device).type == "cpu":
        mesh = DeviceMesh.from_spec(mesh, devices=[torch.device("cpu")])
    if isinstance(mesh, DeviceMesh) and mesh.grid is None and device is None:
        device = mesh.devices[0]
    mesh = resolve_mesh(mesh)
    if mesh is None:
        return None, resolve_device(device)
    lead = mesh.lead_device
    if device is not None:
        want = torch.device(device)
        if want.type != lead.type or want.index not in (None, lead.index):
            raise ValueError(f"device={device!r} is not the lead slot {lead} of {mesh!r}")
    return mesh, lead


def mesh_shape_str(mesh) -> str:
    """``'off'`` | ``'DPxSP'`` for any accepted mesh form: the label the
    dispatch spans and the service's status carry."""
    if mesh is None:
        return "off"
    dm = mesh if isinstance(mesh, DeviceMesh) else DeviceMesh.from_spec(mesh)
    return "off" if dm is None or dm.grid is None else dm.shape_str


def _require(mesh) -> DeviceMesh:
    dm = resolve_mesh(mesh)
    if dm is None:
        raise ValueError(f"a sharded scorer needs a mesh of more than one slot, got {mesh!r}")
    return dm


# ---------------------------------------------------------------------
# the fan-out
# ---------------------------------------------------------------------


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _place(t, dev, stream):
    """``t`` on a slot's device, to be read on that slot's stream."""
    out = t.to(dev, non_blocking=True)
    if out is t and stream is not None:
        t.record_stream(stream)  # made on the lead stream, read on the slot's
    return out


def run_on_slots(mesh, slots, fn, args_for, lead):
    """``fn(*args_for(i, j))`` on every slot of ``slots``: the tensors among
    the arguments placed on the slot's device, run on the slot's stream.
    Returns ``{slot: result}``, each result (a tensor or a tuple of them)
    on ``lead`` and ready for the caller's stream there.

    Every slot is launched before any result is gathered, so the slots
    run concurrently: the slot's stream first waits for the lead stream
    (which made the inputs), and after its launches records an event the
    lead stream waits on.  A failure raises; nothing falls back."""
    lead_stream = torch.cuda.current_stream(lead) if lead.type == "cuda" else None
    launched = {}
    for i, j in slots:
        dev, stream = mesh.grid[i][j], mesh.slot_stream(i, j)
        with _on(stream):
            if stream is not None:
                stream.wait_stream(lead_stream)
            args = [_place(a, dev, stream) if isinstance(a, torch.Tensor) else a
                    for a in args_for(i, j)]
            launched[(i, j)] = (fn(*args), stream)
    results = {}
    for slot, (out, stream) in launched.items():
        with _on(stream):
            parts = list(out) if isinstance(out, (tuple, list)) else [out]
            moved = [p.to(lead, non_blocking=True) for p in parts]
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
                lead_stream.wait_event(done)
                for p, m in zip(parts, moved):
                    if m is p:
                        p.record_stream(lead_stream)  # made on the slot's, read on the lead
        results[slot] = tuple(moved) if isinstance(out, (tuple, list)) else moved[0]
    return results


def lse_combine(parts, group=None):
    """Shard partials (a list of equal-shape tensors, each a logsumexp over
    its shard's components) combined into the logsumexp over every shard:
    the MAX, then the SUM of ``exp(partial − max)``, then ``max +
    log(sum)``.  ``group``: the process group of the shards held by other
    ranks (``DeviceMesh.row_group``), each step then an all-reduce over
    it.  A partial near NEG_BIG (a shard of padding only) adds exactly 0."""
    stacked = torch.stack(parts)
    m = stacked.amax(dim=0).clamp(min=NEG_BIG)
    if group is not None:
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX, group=group)
    s = torch.exp(stacked - m[None]).sum(dim=0)
    if group is not None:
        torch.distributed.all_reduce(s, torch.distributed.ReduceOp.SUM, group=group)
    return m + torch.log(s)


def sum_combine(parts, group=None):
    """Shard partial sums combined into the sum over every shard (an
    all-reduce over ``group`` across processes)."""
    s = torch.stack(parts).sum(dim=0)
    if group is not None:
        torch.distributed.all_reduce(s, torch.distributed.ReduceOp.SUM, group=group)
    return s


def _assemble(mesh, rows, like, n):
    """The ``dp`` rows' results (``rows[i]``: this process's result for row
    ``i``, or None where it owns no slot of it) concatenated along the
    last axis and cut to ``n``.  Across processes the rows are shared: the
    lowest rank of each row contributes it to a sum over every rank."""
    group = mesh.all_group()
    if group is None:
        return torch.cat(rows, dim=-1)[..., :n]
    me = _rank()
    full = []
    for i, r in enumerate(rows):
        first = min(mesh.owner(i, j) for j in range(mesh.sp))
        full.append(r if r is not None and first == me else torch.zeros_like(like))
    out = torch.cat(full, dim=-1)
    torch.distributed.all_reduce(out, torch.distributed.ReduceOp.SUM, group=group)
    return out[..., :n]


def _blocks(x, n, fill=0.0):
    """``x``'s last axis padded with ``fill`` to ``n`` equal blocks of at
    least one element each, and cut into them (contiguous)."""
    k = x.shape[-1]
    width = max(-(-k // n), 1)
    if width * n > k:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (width * n - k,), fill)], dim=-1)
    return [x[..., i * width:(i + 1) * width].contiguous() for i in range(n)]


def _region_shards(params, k_below, sp):
    """The pair block ``[L, 3, K]`` as ``sp`` shards ``[L, 3, wb + wa]``:
    block ``j`` of the below region then block ``j`` of the above, each
    region padded with ``(0, 0, NEG_BIG)`` columns to ``sp`` blocks of at
    least one column.  Returns the shards and their ``k_below`` (wb)."""
    n_labels = params.shape[0]
    regions = []
    for region in (params[..., :k_below], params[..., k_below:]):
        k = region.shape[-1]
        width = max(-(-k // sp), 1)
        padded = torch.nn.functional.pad(region, (0, width * sp - k))
        padded[:, 2, k:] = NEG_BIG
        regions.append(padded.view(n_labels, 3, sp, width))
    # [sp, L, 3, wb + wa], one copy; shard j is its contiguous slice j
    shards = torch.cat(regions, dim=-1).permute(2, 0, 1, 3).contiguous()
    return list(shards.unbind(0)), regions[0].shape[-1]


def _combine_rows(mesh, parts, combine):
    """``combine(i, mine)`` for each ``dp`` row ``i`` over this process's
    shard results ``mine`` (in ``sp`` order); None for a row it holds no
    slot of."""
    rows = []
    for i in range(mesh.dp):
        mine = [parts[(i, j)] for j in range(mesh.sp) if (i, j) in parts]
        rows.append(combine(i, mine) if mine else None)
    return rows


# ---------------------------------------------------------------------
# the scorers
# ---------------------------------------------------------------------


def make_sharded_pair_score_batched(mesh):
    """Label-stacked sharded pair scorer, the mesh counterpart of
    ``ops.score.pair_score`` and of the pair-score kernel, batched over a
    family's L labels: ``score(z, params, k_below)`` with ``z`` [L, C],
    ``params`` [L, 3, K] (``ops.score.pair_params``) → ``log l − log g``
    [L, C], up to the additive constants ``pair_score`` drops.

    Candidates shard over ``dp`` and each region of the component axis
    over ``sp`` (the module docstring's layout); each slot launches
    ``ops.pair_kernel.pair_lse_partials`` once.  Any C and K: the
    padding is made here.  Reference: ``sharding.py:345``."""
    from ..ops.pair_kernel import pair_lse_partials

    mesh = _require(mesh)

    def score(z, params, k_below):
        z_blocks = _blocks(z, mesh.dp)
        shards, kb = _region_shards(params, int(k_below), mesh.sp)
        parts = run_on_slots(mesh, mesh.local_slots(), pair_lse_partials,
                             lambda i, j: (z_blocks[i], shards[j], kb), z.device)
        rows = _combine_rows(mesh, parts, lambda i, mine: lse_combine(mine, mesh.row_group(i)))
        out = _assemble(mesh, rows, parts[next(iter(parts))], z.shape[-1])  # [2, L, C]
        return out[0] - out[1]

    return score


def _mixture_scorer(mesh, partials, finish, lse_first):
    """A scorer ``score(cand, wb, mb, sb, wa, ma, sa, *bounds)`` → ``[C]``
    of the two mixtures: candidates cut over ``dp``, both mixtures' (w, mu,
    sigma) over ``sp`` (padded with weight-0 components, as
    :func:`pad_mixture` pads).  ``partials(c, w, mu, sigma, *bounds)`` is
    one mixture's shard step, a pair of tensors; ``finish(c, first,
    second, *bounds)`` turns a row's combined pair (each side stacked
    below, above) into its scores: ``first`` combined by a logsumexp when
    ``lse_first``, else by a sum, ``second`` by a sum."""
    mesh = _require(mesh)

    def score(cand, wb, mb, sb, wa, ma, sa, *bounds):
        bounds = [torch.as_tensor(v, dtype=torch.float32, device=cand.device) for v in bounds]
        c_blocks = _blocks(cand, mesh.dp)
        below = list(zip(*(_blocks(a, mesh.sp, f) for a, f in zip((wb, mb, sb), (0.0, 0.0, 1.0)))))
        above = list(zip(*(_blocks(a, mesh.sp, f) for a, f in zip((wa, ma, sa), (0.0, 0.0, 1.0)))))

        def shard(c, wb_, mb_, sb_, wa_, ma_, sa_, *bs):
            b, a = partials(c, wb_, mb_, sb_, *bs), partials(c, wa_, ma_, sa_, *bs)
            return torch.stack([b[0], a[0]]), torch.stack([b[1], a[1]])

        parts = run_on_slots(mesh, mesh.local_slots(), shard,
                             lambda i, j: (c_blocks[i], *below[j], *above[j], *bounds),
                             cand.device)

        def combine(i, mine):
            group = mesh.row_group(i)
            first = (lse_combine if lse_first else sum_combine)([p[0] for p in mine], group)
            return finish(c_blocks[i], first, sum_combine([p[1] for p in mine], group), *bounds)

        return _assemble(mesh, _combine_rows(mesh, parts, combine), c_blocks[0], cand.shape[-1])

    return score


def _lpdf_partials(cand, w, mu, sigma, low, high):
    """One shard of a continuous truncated-GMM lpdf: per candidate the
    logsumexp of its components' log-densities, and the components'
    in-bounds mass."""
    sigma = sigma.clamp(min=EPS)
    logw = torch.log(w.clamp(min=EPS))
    comp = (-0.5 * ((cand[:, None] - mu[None, :]) / sigma[None, :]) ** 2
            - torch.log(sigma * _SQRT_2PI)[None, :] + logw[None, :])
    m = comp.amax(dim=1).clamp(min=NEG_BIG)
    lse = m + torch.log(torch.exp(comp - m[:, None]).sum(dim=1))
    p_acc = (w * (_cdf(high, mu, sigma) - _cdf(low, mu, sigma))).sum()
    return lse, p_acc


def _lpdf_finish(c, ll, p_acc, low, high):
    # each side's lpdf is -inf out of bounds in the reference: NaN here
    diff = ((ll[0] - torch.log(p_acc[0].clamp(min=EPS)))
            - (ll[1] - torch.log(p_acc[1].clamp(min=EPS))))
    return torch.where((c >= low) & (c < high), diff, float("nan"))


def make_sharded_score(mesh):
    """Sharded ``log l − log g`` scorer of continuous labels:
    ``score(cand, wb, mb, sb, wa, ma, sa, low, high)`` → ``[C]``, the exact
    truncated-GMM density difference of ``ops.gmm.gmm_lpdf`` (continuous):
    per shard each candidate's logsumexp over the shard's components and
    the in-bounds mass, combined by a logsumexp and a sum.  Reference:
    ``sharding.py:242``."""
    return _mixture_scorer(mesh, _lpdf_partials, _lpdf_finish, lse_first=True)


def make_sharded_quantized_score(mesh, log_scale: bool):
    """Sharded quantized pair scorer: ``log l − log g`` where each term
    integrates the candidate's bucket ``[x − q/2, x + q/2]`` against the
    mixture by CDF differences (``ops.gmm.gmm_lpdf``'s quantized
    semantics): ``score(cand, wb, mb, sb, wa, ma, sa, low, high, q)`` →
    ``[C]``.  The bucket mass and ``p_accept`` are plain sums over
    components, so each shard's partial sums are combined by a SUM.
    Reference: ``sharding.py:286``."""

    def qprob(x, w, mu, sigma, low, high, q):
        qq = q.clamp(min=EPS)
        if log_scale:
            raw_low = torch.where(torch.isfinite(low), torch.exp(low), 0.0)
            raw_high = torch.where(torch.isfinite(high), torch.exp(high), float("inf"))
            ub_z = _log_cdf_arg(torch.minimum(x + qq / 2.0, raw_high))
            lb_z = _log_cdf_arg(torch.clamp(torch.maximum(x - qq / 2.0, raw_low), min=0.0))
        else:
            ub_z = torch.minimum(x + qq / 2.0, high)
            lb_z = torch.maximum(x - qq / 2.0, low)
        prob = (w[None, :] * (_cdf(ub_z[:, None], mu[None, :], sigma[None, :])
                              - _cdf(lb_z[:, None], mu[None, :], sigma[None, :]))).sum(dim=1)
        pacc = (w * (_cdf(high, mu, sigma) - _cdf(low, mu, sigma))).sum()
        return prob, pacc

    def finish(c, prob, pacc, *bounds):
        logp = torch.log(prob.clamp(min=EPS)) - torch.log(pacc.clamp(min=EPS))[:, None]
        return logp[0] - logp[1]

    return _mixture_scorer(mesh, qprob, finish, lse_first=False)


def _best(score_fn):
    def best(cand, x_pad, *args, k, n_cand):
        s = score_fn(x_pad, *args)[: k * n_cand].reshape(k, n_cand)
        c = cand[: k * n_cand].reshape(k, n_cand)
        return c.gather(1, torch.argmax(s, dim=1)[:, None])[:, 0]

    return best


def make_sharded_best(mesh):
    """:func:`make_sharded_score`, then the per-id argmax:
    ``best(cand, z_pad, wb, mb, sb, wa, ma, sa, low, high, *, k, n_cand)``
    → the ``[k]`` winning candidates, on the lead device.  Reference:
    ``sharding.py:397``."""
    return _best(make_sharded_score(mesh))


def make_sharded_best_quantized(mesh, log_scale: bool):
    """The quantized-dist variant of :func:`make_sharded_best` (the
    bucket-integral scorer; candidates are raw values).  Reference:
    ``sharding.py:419``."""
    return _best(make_sharded_quantized_score(mesh, log_scale))


def dp_apply(mesh, fn, batch, lead, shared=()):
    """``fn(block, *shared)`` over a batch split along its last axis into
    the mesh's ``dp`` rows, each row on its first slot owned by this
    process (``shared`` tensors placed on every such slot), the results
    concatenated on ``lead``.  ``batch``: a tensor or a dict of tensors
    with one last-axis extent; ``fn`` maps the same form of one block to a
    tensor of the block's last-axis extent.  Per-element work only, so
    each value is ``fn``'s over the whole batch."""
    as_dict = isinstance(batch, dict)
    items = batch if as_dict else {"": batch}
    keys = list(items)
    n = items[keys[0]].shape[-1]
    blocks = {k: _blocks(v, mesh.dp) for k, v in items.items()}
    slots = [s for s in (mesh.row_slot(i) for i in range(mesh.dp)) if s is not None]

    def run(*vals):
        x = dict(zip(keys, vals[:len(keys)])) if as_dict else vals[0]
        return fn(x, *vals[len(keys):])

    parts = run_on_slots(mesh, slots, run,
                         lambda i, j: [blocks[k][i] for k in keys] + list(shared), lead)
    rows = [parts.get(mesh.row_slot(i)) for i in range(mesh.dp)]
    like = next(r for r in rows if r is not None)
    return _assemble(mesh, rows, like, n)


def make_sharded_batch_eval(mesh, fn):
    """Vectorized on-device objective evaluation, the batch split over
    ``dp``: ``fn`` is a per-configuration torch function of a dict of 0-d
    tensors; the returned ``run(batch)`` evaluates ``{label: [B]}`` (B a
    multiple of ``dp``) as one ``torch.func.vmap(fn)`` call per ``dp``
    row, each on its row's slot and stream, and returns ``[B]`` losses on
    the lead device.  Reference: ``sharding.py:437``."""
    mesh = _require(mesh)
    vf = torch.func.vmap(fn)

    def run(batch):
        lead = mesh.lead_device
        placed = {k: torch.as_tensor(v).to(lead) for k, v in batch.items()}
        n = next(iter(placed.values())).shape[0]
        if n % mesh.dp:
            raise ValueError(f"batch of {n} does not split over dp={mesh.dp}; pad it")
        return dp_apply(mesh, vf, placed, lead)

    return run


def pad_mixture(w, mu, sigma, total):
    """Pad mixture arrays to ``total`` (weight-0 tail) for even sharding."""
    k = len(w)
    assert total >= k
    wp = np.zeros(total, np.float32)
    mp = np.zeros(total, np.float32)
    sp_ = np.ones(total, np.float32)
    wp[:k], mp[:k], sp_[:k] = w, mu, sigma
    return wp, mp, sp_


__all__ = [
    "DeviceMesh", "default_mesh", "default_shape", "dp_apply", "drop_slot_streams",
    "local_devices", "lse_combine", "sum_combine", "make_sharded_batch_eval", "make_sharded_best",
    "make_sharded_best_quantized", "make_sharded_pair_score_batched",
    "make_sharded_quantized_score", "make_sharded_score", "mesh_shape_str", "pad_mixture",
    "resolve_mesh", "resolve_mesh_device", "run_on_slots",
]
