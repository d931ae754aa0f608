"""Roofline-aware device performance observability.

Reference parity: ``hyperopt_tpu/profiling.py``.  What it gives:

- a per-dispatch **cost model**: FLOPs *and* bytes moved for every suggest
  dispatch signature, from an analytical per-family model
  (:func:`analytical_cost`: arithmetic on shapes, cheap enough for every
  dispatch).  The reference's second model, ``xla_cost`` (XLA's own cost
  analysis of the lowered program), has no counterpart: nothing here
  lowers a program, so the analytical model is the only one;
- **roofline attribution** (:func:`roofline`): arithmetic intensity
  against the ridge point decides which ceiling *binds* a dispatch,
  memory bandwidth or peak FLOP/s, and ``roofline_pct`` is the share of
  that binding ceiling achieved;
- a :class:`DeviceProfiler` observer on ``tpe_device._suggest_observers``:
  every dispatch records its device time, achieved GB/s and TFLOP/s,
  binding ceiling, roofline share and live-buffer bytes into an
  :class:`~hyperopt_tpu_torch.observability.DeviceStats` (Prometheus
  gauges through ``render_prometheus(device=...)``);
- an opt-in bounded :class:`ProfileCapture` over ``torch.profiler`` (N
  dispatches, a Chrome trace under ``log_dir``).

Timing: on the card ``device_s`` is the span between two CUDA events on
the suggest stream, before the first launch and after the last one
(``tpe_device.multi_family_suggest_async``).  A suggest is about two
thousand small launches issued from Python, so that span includes the
gaps where the card waits for the host's next launch: it is the card's
wall time for the dispatch, not its busy time, and the roofline share
computed from it is a lower bound.  On the CPU the figure is the
reference's host-observed one.

A mesh dispatch (:func:`dispatch_mesh`) spans the mesh's devices: its
record names each distinct device once (:func:`dispatch_devices`; slots
that share a card are one card), its ceilings are the sum of theirs, and
the allocator's peak is read per card.  The device span is the lead
stream's, which waits for every slot's event.
"""

from __future__ import annotations

import logging
import os
import threading

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------
# Hardware ceilings
# ---------------------------------------------------------------------

# NVIDIA H100 SXM: 67 TFLOP/s of f32 on the CUDA cores (the port's kernels
# are FMA, never TF32, by the port's precision rule) and 3.35 TB/s HBM3.
# The figures chip_smoke.py's bounds divide by.
CUDA_PEAK_TFLOPS = 67.0
CUDA_PEAK_HBM_GBPS = 3350.0

# Nominal single-socket CPU ceilings so CPU runs still carry
# self-consistent, non-null roofline attribution.  Order-of-magnitude
# placeholders, flagged by ``source: "nominal_cpu"``: never compare a CPU
# roofline_pct with a card's.
CPU_PEAK_TFLOPS = 0.2
CPU_PEAK_DRAM_GBPS = 25.0


def platform_peaks(platform: str) -> dict:
    """The {peak_tflops, peak_hbm_GBps, ridge_ai, source} ceiling set for
    ``platform`` ("cuda"/"cpu"/...).  The env overrides
    ``HYPEROPT_TPU_PEAK_TFLOPS`` / ``HYPEROPT_TPU_PEAK_HBM_GBPS`` pin other
    cards without a code change.

    ``ridge_ai`` is the roofline ridge point in FLOPs/byte: programs below
    it cannot reach the FLOP peak however good the kernel, memory
    bandwidth binds them.
    """
    if platform == "cuda":
        peak_tflops, peak_bw = CUDA_PEAK_TFLOPS, CUDA_PEAK_HBM_GBPS
        source = "h100_sxm_datasheet"
    else:
        peak_tflops, peak_bw = CPU_PEAK_TFLOPS, CPU_PEAK_DRAM_GBPS
        source = f"nominal_{platform}"
    env_f = os.environ.get("HYPEROPT_TPU_PEAK_TFLOPS")
    env_b = os.environ.get("HYPEROPT_TPU_PEAK_HBM_GBPS")
    if env_f:
        peak_tflops, source = float(env_f), "env_override"
    if env_b:
        peak_bw, source = float(env_b), "env_override"
    return {
        "peak_tflops": peak_tflops,
        "peak_hbm_GBps": peak_bw,
        "ridge_ai": (peak_tflops * 1e12) / (peak_bw * 1e9),
        "source": source,
    }


def roofline(flops: float, bytes_moved: float, device_s: float,
             peaks: dict) -> dict:
    """Attribute one dispatch to the roofline ceiling that binds it.

    Arithmetic intensity ``AI = flops / bytes`` below the ridge point
    means the attainable FLOP/s is ``AI * peak_BW``: memory bandwidth is
    the binding ceiling and ``roofline_pct`` is achieved GB/s over peak
    GB/s.  At or above the ridge the FLOP peak binds and ``roofline_pct``
    is achieved TFLOP/s over peak TFLOP/s.  Both per-ceiling percentages
    are always reported.  (The ``_mxu`` key is the reference's name for
    the FLOP ceiling's share.)
    """
    flops = max(float(flops), 0.0)
    bytes_moved = max(float(bytes_moved), 0.0)
    if device_s <= 0.0 or (flops == 0.0 and bytes_moved == 0.0):
        return {
            "achieved_tflops": None, "achieved_GBps": None,
            "ai_flops_per_byte": None, "ridge_ai": peaks["ridge_ai"],
            "binding_ceiling": None, "roofline_pct": None,
            "roofline_pct_mxu": None, "roofline_pct_bw": None,
        }
    achieved_tflops = flops / device_s / 1e12
    achieved_gbps = bytes_moved / device_s / 1e9
    pct_mxu = 100.0 * achieved_tflops / peaks["peak_tflops"]
    pct_bw = 100.0 * achieved_gbps / peaks["peak_hbm_GBps"]
    ai = flops / bytes_moved if bytes_moved else float("inf")
    binding = "hbm_bw" if ai < peaks["ridge_ai"] else "flops"
    return {
        "achieved_tflops": achieved_tflops,
        "achieved_GBps": achieved_gbps,
        "ai_flops_per_byte": None if ai == float("inf") else ai,
        "ridge_ai": peaks["ridge_ai"],
        "binding_ceiling": binding,
        "roofline_pct": pct_bw if binding == "hbm_bw" else pct_mxu,
        "roofline_pct_mxu": pct_mxu,
        "roofline_pct_bw": pct_bw,
    }


# ---------------------------------------------------------------------
# Cost model: FLOPs and bytes per suggest dispatch
# ---------------------------------------------------------------------

_F32 = 4  # every device buffer of the suggest plane is 4-byte wide per value


def _cont_request_cost(args, statics) -> dict:
    """Analytical (flops, bytes) for one continuous-family request.
    Terms below ~1% of the totals at the main path's shapes (prior
    uploads, argmax, counts) are left out, as in the reference."""
    from .ops.score import pair_score_cost

    obs = args[1]
    losses = args[4]
    L, cap = int(obs.shape[0]), int(obs.shape[1])
    capt = int(losses.shape[0])
    k = int(statics["k"])
    n_cand = int(statics["n_cand"])
    cap_b = int(statics["cap_b"])
    C = k * n_cand
    K = (cap_b + 1) + (cap + 1)
    quantized = bool(statics.get("quantized"))
    n_buckets = int(statics.get("n_buckets", 0) or 0)
    scorer = statics.get("scorer", "xla")

    # split/fit/draw: the loss ranks over [CAPT] (shared by the family),
    # per-label packs over [cap], Parzen fits ~O(cap), and the
    # truncated-GMM draw ~O(C)
    flops = 16.0 * capt + L * (32.0 * cap + 12.0 * C)
    # input residency: obs+pos [L,cap] x2, losses+keep+ranks [CAPT]
    bytes_moved = 2.0 * L * cap * _F32 + 3.0 * capt * _F32
    if scorer != "fused" or quantized:
        # candidates: written by the draw, read by the scorer (the fused
        # kernel's own candidate traffic is in pair_score_cost)
        bytes_moved += 2.0 * L * C * _F32
    mxu_flops = 0.0
    if quantized and n_buckets > 0:
        # bucket-grid scoring: the exact quantized lpdf on a [B] grid per
        # side (erf-based CDF, ~30 flops/cell), then an O(C) gather
        flops += L * (2.0 * 30.0 * n_buckets * K + 4.0 * C)
        bytes_moved += L * (2.0 * n_buckets * K * _F32 + C * _F32)
    elif quantized or scorer == "exact":
        # per-candidate exact lpdf: [C, K] erf broadcast per side
        flops += L * 2.0 * 30.0 * C * K
        bytes_moved += L * 2.0 * C * K * _F32
    else:
        sc = pair_score_cost(C, K, scorer)
        flops += L * sc["flops"]
        bytes_moved += L * sc["bytes"]
        mxu_flops = L * sc["mxu_flops"]
    # winners out
    bytes_moved += L * k * _F32
    return {"flops": flops, "bytes": bytes_moved, "mxu_flops": mxu_flops}


def _idx_request_cost(args, statics) -> dict:
    """Analytical (flops, bytes) for one index-family request."""
    obs = args[1]
    losses = args[4]
    prior_p = args[8]
    L, cap = int(obs.shape[0]), int(obs.shape[1])
    capt = int(losses.shape[0])
    U = int(prior_p.shape[1])
    C = int(statics["k"]) * int(statics["n_cand"])
    # posterior scatter-add over [cap] per side + [U] normalize, then a
    # C-candidate draw and two O(C) categorical lpdf gathers
    flops = 16.0 * capt + L * (2.0 * (4.0 * cap + 6.0 * U) + 10.0 * C)
    bytes_moved = (
        2.0 * L * cap * _F32 + 3.0 * capt * _F32
        + 2.0 * L * U * _F32 + 3.0 * L * C * _F32
        + L * int(statics["k"]) * _F32
    )
    return {"flops": flops, "bytes": bytes_moved, "mxu_flops": 0.0}


def analytical_cost(requests) -> dict:
    """{flops, bytes, mxu_flops, source} for one multi-family request
    list: pure shape arithmetic, safe on every dispatch.  ``mxu_flops`` is
    the matmul-only subset (the reference's name)."""
    total = {"flops": 0.0, "bytes": 0.0, "mxu_flops": 0.0}
    for kind, args, statics in requests:
        one = (
            _cont_request_cost(args, statics) if kind == "cont"
            else _idx_request_cost(args, statics)
        )
        for key in total:
            total[key] += one[key]
    total["source"] = "analytical"
    return total


def signature_key(requests) -> str:
    """A human-readable stable key for one dispatch signature: the row key
    of the profiler's roofline table and of its cost cache.  Carries every
    shape and static the cost model branches on (``cap_b``, the scorer
    tier, the quantization grid), so two dispatches whose costs can differ
    never share a key."""
    parts = []
    capt = 0
    for kind, args, statics in requests:
        obs = args[1]
        losses = args[4]
        capt = max(capt, int(losses.shape[0]))
        bits = [
            f"L{int(obs.shape[0])}", f"cap{int(obs.shape[1])}",
            f"capb{int(statics['cap_b'])}",
            f"k{int(statics['k'])}", f"c{int(statics['n_cand'])}",
        ]
        if kind == "cont":
            bits.append(str(statics.get("scorer", "?")))
            if statics.get("quantized"):
                bits.append(f"q{int(statics.get('n_buckets', 0) or 0)}")
            if statics.get("log_scale"):
                bits.append("log")
            if statics.get("mesh") is not None:
                bits.append(f"mesh{statics['mesh'].shape_str}")
        else:
            bits.append(f"u{int(statics.get('upper', 0) or 0)}")
        parts.append(f"{kind}[{','.join(bits)}]")
    return f"capt{capt}:" + "+".join(parts)


def dispatch_mesh(requests):
    """The ``DeviceMesh`` a request list shards over, or None for the
    single-device dispatch: one dispatch has one mesh, so the first
    family that carries one names it."""
    for _, _, statics in requests:
        mesh = statics.get("mesh")
        if mesh is not None:
            return mesh
    return None


def dispatch_devices(requests):
    """Stable labels ('<type>:<index>') of the devices the dispatch of
    ``requests`` runs on: the one device its history lies on (every
    request of one suggest shares it), or under a mesh every device of
    this process's slots, each once, the lead first.  The per-device
    telemetry split keys on these labels."""
    devs = [requests[0][1][1].device]
    mesh = dispatch_mesh(requests)
    if mesh is not None:
        devs += [mesh.grid[i][j] for i, j in mesh.local_slots()]
    return list(dict.fromkeys(f"{d.type}:{d.index or 0}" for d in devs))


# ---------------------------------------------------------------------
# The dispatch observer
# ---------------------------------------------------------------------

_tls = threading.local()


def last_dispatch_record(consume: bool = True):
    """The most recent dispatch record produced ON THIS THREAD by an
    installed :class:`DeviceProfiler` (None when none).  ``consume`` clears
    it so a later dispatch can never be attributed a stale record."""
    rec = getattr(_tls, "last_record", None)
    if consume:
        _tls.last_record = None
    return rec


class DeviceProfiler:
    """The per-dispatch roofline observer.

    ``install()`` registers on ``tpe_device._suggest_observers``; for every
    dispatch it computes the cost (cached per signature: the steady state
    is one dict lookup) and returns a completion callback the resolver
    fires with the dispatch's timings.  Each completed dispatch becomes one
    record in ``stats`` (:class:`~hyperopt_tpu_torch.observability.
    DeviceStats`) and this thread's :func:`last_dispatch_record`.

    Overhead contract: not installed, ``_suggest_observers`` stays empty
    and the dispatch path pays one truthiness check.  Installed, a CUDA
    dispatch also records two timing events (``chip_smoke.py``'s
    ``profiler`` phase measures that cost; the reference's acceptance is
    a suggest p50 within 5%).
    """

    def __init__(self, stats=None, peaks=None):
        from .observability import DeviceStats

        self.stats = stats if stats is not None else DeviceStats()
        self._peaks = peaks
        self._lock = threading.Lock()
        self._cost_cache = {}  # guarded-by: _lock  (sig_key -> cost dict)
        self._installed = None
        # disarmed after the first failure or a backend without an
        # allocator peak (the CPU): probe once, not per dispatch
        self._backend_mem = True

    def install(self):
        if self._installed is not None:
            return self
        from .algos import tpe_device

        tpe_device._suggest_observers.append(self._observe)
        self._installed = self._observe
        return self

    def uninstall(self):
        if self._installed is None:
            return
        from .algos import tpe_device

        try:
            tpe_device._suggest_observers.remove(self._installed)
        except ValueError:
            pass
        self._installed = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- the observer --------------------------------------------------
    def _observe(self, requests):
        """Fires on the launching thread once per dispatch, BEFORE the
        launches.  Returns the completion callback the resolver invokes
        with the timing event; never raises (profiling cannot fail a
        suggest)."""
        try:
            sig_key = signature_key(requests)
            with self._lock:
                cached = self._cost_cache.get(sig_key)
            if cached is None:
                devices = dispatch_devices(requests)
                peaks = self._peaks or platform_peaks(devices[0].split(":")[0])
                if len(devices) > 1:
                    # a mesh dispatch spans len(devices) cards: the
                    # aggregate ceilings scale with them (the ridge point
                    # does not move)
                    peaks = dict(peaks)
                    peaks["peak_tflops"] *= len(devices)
                    peaks["peak_hbm_GBps"] *= len(devices)
                    peaks["source"] = f"{peaks['source']}_x{len(devices)}"
                cached = (analytical_cost(requests), devices, peaks)
                with self._lock:
                    self._cost_cache[sig_key] = cached
            cost, devices, peaks = cached
            # live-buffer residency of this dispatch: every tensor it reads
            # (nbytes is shape metadata, no transfer)
            arg_bytes = 0
            for _, args, _ in requests:
                for a in args:
                    arg_bytes += int(getattr(a, "nbytes", 0))
            stats = self.stats
        except Exception:
            logger.warning("device profiler observe failed", exc_info=True)
            return None

        def _on_complete(event):
            try:
                if event.get("error"):
                    return  # failed readback: no timings to attribute
                device_s = float(event["device_s"])
                roof = roofline(cost["flops"], cost["bytes"], device_s, peaks)
                rec = {
                    "sig": sig_key,
                    "n_requests": int(event.get("n_requests", 1)),
                    "device_s": device_s,
                    "launch_s": float(event.get("launch_s", 0.0)),
                    "wait_s": float(event.get("wait_s", 0.0)),
                    "readback_s": float(event.get("readback_s", 0.0)),
                    "flops": cost["flops"],
                    "mxu_flops": cost["mxu_flops"],
                    "hbm_bytes": cost["bytes"],
                    "live_bytes": arg_bytes + int(event.get("out_bytes", 0)),
                    "cost_source": cost["source"],
                    "compiled": bool(event.get("compiled", False)),
                    "devices": list(devices),
                }
                if self._backend_mem:
                    self._record_backend_peak(devices, stats)
                rec.update(roof)
                stats.record_dispatch(rec)
                _tls.last_record = rec
            except Exception:
                logger.warning("device profiler record failed", exc_info=True)

        return _on_complete

    def _record_backend_peak(self, devices, stats):
        """The caching allocator's peak per card into ``stats``; disarms
        itself for devices that report none (the CPU)."""
        try:
            import torch

            any_mem = False
            for label in devices:
                kind, _, index = label.partition(":")
                if kind == "cuda":
                    stats.set_backend_peak_bytes(
                        torch.cuda.max_memory_allocated(int(index)), device=label
                    )
                    any_mem = True
            if not any_mem:
                self._backend_mem = False
        except Exception:
            self._backend_mem = False


# ---------------------------------------------------------------------
# Bounded torch.profiler capture
# ---------------------------------------------------------------------


class ProfileCapture:
    """Opt-in ``torch.profiler`` capture of the first N dispatches.

    Starts a profiler at the first dispatch after :meth:`install` and
    stops it once ``max_dispatches`` have *resolved*, so the capture holds
    complete dispatches and stays bounded however long the process lives;
    the Chrome trace lands under ``log_dir``.  Never raises into the
    dispatch path; a profiler that cannot start logs once and disarms.
    """

    # lock-order: _lock
    def __init__(self, log_dir, max_dispatches: int = 16):
        self.log_dir = str(log_dir)
        self.max_dispatches = int(max_dispatches)
        self._lock = threading.Lock()
        self._started = False  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock
        self._n_seen = 0  # guarded-by: _lock
        self._n_resolved = 0  # guarded-by: _lock
        self._installed = None
        self._prof = None

    def install(self):
        if self._installed is not None or self.max_dispatches <= 0:
            return self
        from .algos import tpe_device

        tpe_device._suggest_observers.append(self._observe)
        self._installed = self._observe
        return self

    def uninstall(self):
        if self._installed is not None:
            from .algos import tpe_device

            try:
                tpe_device._suggest_observers.remove(self._installed)
            except ValueError:
                pass
            self._installed = None
        self._stop()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def summary(self) -> dict:
        with self._lock:
            return {
                "log_dir": self.log_dir,
                "max_dispatches": self.max_dispatches,
                "started": self._started,
                "stopped": self._stopped,
                "n_captured": min(self._n_resolved, self.max_dispatches),
            }

    def _start(self):
        import torch

        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.log_dir),
            )
            self._prof.start()
            return True
        except Exception:
            logger.warning("torch.profiler capture unavailable; disarming",
                           exc_info=True)
            return False

    def _stop(self):
        with self._lock:
            if not self._started or self._stopped:
                self._stopped = True
                return
            self._stopped = True
        try:
            self._prof.stop()
            logger.info("device profile captured to %s (%d dispatches)",
                        self.log_dir, self.max_dispatches)
        except Exception:
            logger.warning("torch.profiler stop failed", exc_info=True)

    def _observe(self, requests):
        with self._lock:
            if self._stopped:
                return None
            if self._n_seen >= self.max_dispatches:
                past_budget = True
            else:
                past_budget = False
                self._n_seen += 1
            need_start = not past_budget and not self._started
            if need_start:
                self._started = True
        if past_budget:
            # backstop: a budgeted dispatch whose resolver never ran (a
            # discarded speculation) must not leave the capture open; the
            # first dispatch past budget closes it
            self._stop()
            return None
        if need_start and not self._start():
            with self._lock:
                self._stopped = True
            return None

        def _on_complete(event):
            # error events count too: a failed readback consumed budget
            with self._lock:
                self._n_resolved += 1
                done = self._n_resolved >= self.max_dispatches
            if done:
                self._stop()

        return _on_complete
