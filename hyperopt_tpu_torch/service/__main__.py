"""CLI: ``python -m hyperopt_tpu_torch.service`` — run the optimization
server (console script ``hyperopt-tpu-torch-service``).

Serves on the CUDA card by default and exits with an error without one
unless ``--device cpu`` is given.

Serves until SIGTERM/SIGINT, then drains gracefully: new suggests are
rejected with 503, admitted ones complete, study state is already
write-through on disk, and the process exits 0.  Re-running with the
same ``--root`` recovers every study — including after ``kill -9``: the
startup fsck repairs torn docs/journals and the response-journal replay
restores any commit the crash interrupted.

Subcommand::

    python -m hyperopt_tpu_torch.service fsck <root> [--repair] [--json]

checks (dry-run by default) a service root or single queue directory
for crash damage; see ``hyperopt_tpu_torch.resilience.fsck`` for the
rule catalog.  Reference parity: ``hyperopt_tpu/service/__main__.py``.

Multi-replica mode: N servers started with ``--replica-id`` on one
``--root`` split the studies between them; SIGTERM drains, releases
every study lease (its fence kept) and withdraws the replica's
directory record, so a sibling adopts its studies at once.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from .core import (
    DEFAULT_BATCH_WINDOW,
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_QUEUE,
    DEFAULT_MAX_STUDIES,
    OptimizationService,
)
from .server import ServiceServer

logger = logging.getLogger("hyperopt_tpu_torch.service")


def make_parser():
    p = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.service",
        description="Multi-study TPE suggest server with continuous "
                    "cross-study batching on the CUDA card.",
    )
    p.add_argument(
        "--device", default=None, dest="device",
        help="where suggests run: 'cuda' (the default; without a card "
             "the server refuses to start) or 'cpu'",
    )
    p.add_argument(
        "--root", default=None,
        help="service root directory for durable study state "
             "(omit for an ephemeral in-memory server)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--unsafe-allow-remote", action="store_true",
        dest="unsafe_allow_remote",
        help="permit binding a non-loopback host.  DANGEROUS: the API "
             "deserializes client-supplied pickled spaces (arbitrary "
             "code execution) and has no auth — the trust model is "
             "cooperating clients on the same host/pod.  Front it with "
             "an authenticating proxy before exposing it",
    )
    p.add_argument("--port", type=int, default=8777,
                   help="TCP port (0 binds an ephemeral port)")
    p.add_argument(
        "--batch-window", type=float, default=DEFAULT_BATCH_WINDOW,
        dest="batch_window",
        help="seconds a batch stays open for more suggests to coalesce",
    )
    p.add_argument("--max-batch", type=int, default=DEFAULT_MAX_BATCH,
                   dest="max_batch")
    p.add_argument(
        "--max-queue", type=int, default=DEFAULT_MAX_QUEUE,
        dest="max_queue",
        help="queued-suggest admission limit; beyond it requests get 429",
    )
    p.add_argument("--max-studies", type=int, default=DEFAULT_MAX_STUDIES,
                   dest="max_studies")
    p.add_argument("--log-level", default="INFO", dest="log_level")
    p.add_argument(
        "--trace-sample", type=float, default=0.0, dest="trace_sample",
        help="fraction of requests to trace end-to-end (0 disables "
             "tracing entirely — the hot path pays nothing)",
    )
    p.add_argument(
        "--trace-slow-ms", type=float, default=None, dest="trace_slow_ms",
        help="always write traces whose root exceeds this many "
             "milliseconds, regardless of --trace-sample (tail rescue)",
    )
    p.add_argument(
        "--trace-log", default=None, dest="trace_log",
        help="trace log path (default <root>/trace.jsonl when --root "
             "is set and tracing is enabled)",
    )
    p.add_argument(
        "--profile-dir", default=None, dest="profile_dir",
        help="capture a torch.profiler device trace of the first "
             "--profile-dispatches dispatches into this directory "
             "(view with Perfetto); bounded, then disarms",
    )
    p.add_argument(
        "--profile-dispatches", type=int, default=16,
        dest="profile_dispatches",
        help="how many dispatches --profile-dir captures",
    )
    p.add_argument(
        "--flight-dir", default=None, dest="flight_dir",
        help="flight-recorder bundle directory (default "
             "<root>/flightrec when --root is set); bundles dump on "
             "SLO breach, SIGQUIT, and unhandled crash",
    )
    p.add_argument(
        "--no-slo", action="store_true", dest="no_slo",
        help="turn the guardrails fully off: no SLO ticker, no "
             "hyperopt_slo_* /metrics families, no storage-plane "
             "instrumentation, no flight-recorder retention or dumps "
             "(/v1/alerts still evaluates passively on the service "
             "counters, with store/duty rules reading no_data)",
    )
    p.add_argument(
        "--compile-cache-dir", default=None, dest="compile_cache_dir",
        help="kernel-library build directory (default: build/kernels/ "
             "of the checkout): a restart on it loads the libraries an "
             "earlier process built instead of running nvcc again",
    )
    p.add_argument(
        "--no-warmup", action="store_true", dest="no_warmup",
        help="skip the ledger-driven compile warmup (/readyz then "
             "gates only on recovery + fsck + the device probe, and "
             "first-touch compile events land in the request path)",
    )
    p.add_argument(
        "--cold-fallback", action="store_true", dest="cold_fallback",
        help="cold containment: serve a suggest whose program is not "
             "warm (its dispatch would be a compile event) from the "
             "host-side startup path (tagged served_cold) and warm it "
             "next on the scheduler thread.  "
             "Trades single-study trajectory determinism for tail "
             "latency — off by default",
    )
    p.add_argument(
        "--compile-ledger", default=None, dest="compile_ledger",
        help="compile-ledger path (default <root>/compile_ledger.jsonl "
             "when --root is set)",
    )
    p.add_argument(
        "--mesh", default="off", dest="mesh",
        help="mesh execution mode: 'off' (default, the single-card "
             "dispatch), 'auto' (every local card, degenerate on one) or "
             "an explicit 'DPxSP' shape over all local cards: candidates "
             "shard over dp, Parzen components over sp",
    )
    p.add_argument(
        "--replica-id", default=None, dest="replica_id",
        help="multi-replica mode: this server's stable identity.  N "
             "servers sharing one --root split the studies between "
             "them via fencing-token ownership leases; a dead "
             "replica's studies migrate to the survivors after an "
             "fsck-clean, ledger-pre-warmed takeover.  Requires --root",
    )
    p.add_argument(
        "--advertise-url", default=None, dest="advertise_url",
        help="URL other replicas' clients are redirected to for "
             "studies this replica owns (default http://<host>:<port> "
             "when --port is explicit; required with --port 0)",
    )
    p.add_argument(
        "--replica-ttl", type=float, default=None, dest="replica_ttl",
        help="study-ownership lease TTL in seconds (default 10); a "
             "replica silent this long has its studies reclaimed",
    )
    p.add_argument(
        "--mirror-src-root", default=None, dest="mirror_src_root",
        help="no-shared-root replication: pull the peer root's sealed "
             "trial-log segments into this replica's --root on every "
             "reaper tick (fence-checked cut points), so a takeover "
             "serves from an already-local, CRC-verified copy.  "
             "Requires --replica-id",
    )
    p.add_argument(
        "--self-tune", action="store_true", dest="self_tune",
        help="closed-loop control plane: a background controller runs "
             "TPE over the serving knobs themselves (batch window, "
             "batch size k, speculation depth), scoring each config "
             "over one SLO snapshot window and reverting to the static "
             "config on any SL6xx breach.  Off by default — without "
             "this flag the knob table is provably inert (the "
             "scheduler reads the same static values every batch)",
    )
    p.add_argument(
        "--control-window", type=float, default=30.0,
        dest="control_window",
        help="seconds each self-tune configuration is observed before "
             "it is scored (one objective window)",
    )
    p.add_argument(
        "--control-interval", type=float, default=0.0,
        dest="control_interval",
        help="idle seconds between self-tune cycles (0 = back-to-back "
             "windows)",
    )
    p.add_argument(
        "--control-seed", type=int, default=0, dest="control_seed",
        help="RNG seed for the controller's own TPE search (its Trials "
             "are journaled under <root>/control, so a restart resumes "
             "the tuning history exactly)",
    )
    p.add_argument(
        "--chaos-config", default=None, dest="chaos_config",
        help="TESTING ONLY: JSON ChaosConfig activating seeded "
             "service-plane fault injection (torn writes, connection "
             "resets) inside this server — the chaos-serve campaign's "
             "hook",
    )
    return p


def _build_service(options, tracer, cache_dir, advertise_url):
    return OptimizationService(
        root=options.root,
        batch_window=options.batch_window,
        max_batch=options.max_batch,
        max_queue=options.max_queue,
        max_studies=options.max_studies,
        tracer=tracer,
        slo_enabled=not options.no_slo,
        flight_dir=options.flight_dir,
        compile_cache_dir=cache_dir,
        warmup=not options.no_warmup,
        cold_fallback=options.cold_fallback,
        compile_ledger_path=options.compile_ledger,
        mesh=options.mesh,
        replica_id=options.replica_id,
        advertise_url=advertise_url,
        replica_ttl=options.replica_ttl,
        mirror_src_root=options.mirror_src_root,
        control_enabled=options.self_tune,
        control_window_s=options.control_window,
        control_interval_s=options.control_interval,
        control_seed=options.control_seed,
        device=options.device,
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "fsck":
        from ..resilience.fsck import main as fsck_main

        return fsck_main(argv[1:])
    options = make_parser().parse_args(argv)
    logging.basicConfig(level=getattr(
        logging, options.log_level.upper(), logging.INFO))
    if (
        options.host not in ("127.0.0.1", "::1", "localhost")
        and not options.unsafe_allow_remote
    ):
        logger.error(
            "refusing to bind non-loopback host %r: the service "
            "deserializes client-supplied pickles and has no auth "
            "(pass --unsafe-allow-remote to override)", options.host,
        )
        return 2
    tracer = None
    if options.trace_sample > 0.0 or options.trace_slow_ms is not None:
        import os

        from ..tracing import Tracer

        trace_log = options.trace_log
        if trace_log is None and options.root:
            trace_log = os.path.join(options.root, "trace.jsonl")
        if trace_log is None:
            # tracing with nowhere to land would silently pay the full
            # span cost and discard every trace — refuse up front
            logger.error(
                "tracing enabled (--trace-sample/--trace-slow-ms) but "
                "no trace log destination: pass --trace-log PATH or "
                "--root DIR"
            )
            return 2
        tracer = Tracer(
            path=trace_log,
            sample=options.trace_sample,
            slow_threshold_s=(
                None if options.trace_slow_ms is None
                else options.trace_slow_ms / 1e3
            ),
        )
        logger.info(
            "request tracing on: sample=%.3f slow_ms=%s log=%s",
            options.trace_sample, options.trace_slow_ms, trace_log,
        )
    cache_dir = options.compile_cache_dir
    if cache_dir and cache_dir.lower() == "none":
        cache_dir = None
    advertise_url = options.advertise_url
    if options.replica_id is not None:
        if not options.root:
            logger.error("--replica-id requires --root (a shared store)")
            return 2
        if advertise_url is None:
            if options.port == 0:
                logger.error(
                    "--replica-id with --port 0 needs --advertise-url "
                    "(the redirect target cannot be predicted)"
                )
                return 2
            advertise_url = f"http://{options.host}:{options.port}"
    if options.mirror_src_root and options.replica_id is None:
        logger.error("--mirror-src-root requires --replica-id")
        return 2
    # a --mesh shape that does not cover the local cards raises
    # ValueError (exit 2); no card without --device cpu raises too
    try:
        service = _build_service(
            options, tracer, cache_dir, advertise_url
        )
    except ValueError as e:
        # e.g. a compile cache dir another live replica advertises
        logger.error("%s", e)
        return 2
    logger.info("serving on %s", service.device)
    if service.mesh is not None:
        logger.info("mesh execution mode: %s over %d local device slot(s)",
                    service.mesh_label, service.device_mesh.n_devices)
    if service.replica_set is not None:
        logger.info(
            "replica mode: id=%s advertise=%s ttl=%.1fs",
            options.replica_id, advertise_url, service.replica_set.ttl,
        )
    if service.controller is not None:
        logger.info(
            "self-tune controller ON: window=%.1fs interval=%.1fs "
            "seed=%d knobs=%s",
            options.control_window, options.control_interval,
            options.control_seed,
            ",".join(service.controller.status()["tuned"]),
        )
    # flight-recorder triggers beyond SLO breaches: SIGQUIT ("show me
    # what you were doing") and unhandled crashes (the post-mortem
    # always has its evidence).  --no-slo turns these off too: the
    # guardrails-off server must not write bundles from any trigger.
    from ..slo import install_crash_dump, install_signal_dump

    if service.flight_recorder.bundle_dir and not options.no_slo:
        install_signal_dump(service.flight_recorder)
        install_crash_dump(service.flight_recorder)
    capture = None
    if options.profile_dir:
        from ..profiling import ProfileCapture

        capture = ProfileCapture(
            options.profile_dir,
            max_dispatches=options.profile_dispatches,
        ).install()
        logger.info(
            "device profile capture armed: first %d dispatches -> %s",
            options.profile_dispatches, options.profile_dir,
        )
    server = ServiceServer(service, host=options.host, port=options.port)
    logger.info(
        "optimization service listening on %s (root=%s, window=%.1fms, "
        "max_batch=%d, max_queue=%d)",
        server.url, options.root, options.batch_window * 1e3,
        options.max_batch, options.max_queue,
    )
    print(server.url, flush=True)  # machine-readable for wrappers

    def _graceful(signum, frame):
        logger.info("signal %s: draining and shutting down", signum)
        # off the signal handler's frame: stop() joins threads
        threading.Thread(target=server.stop, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    except ValueError:  # not on the main thread (embedded use)
        pass

    if options.chaos_config:
        from ..resilience.chaos import ChaosConfig, ChaosMonkey, active

        monkey = ChaosMonkey(
            ChaosConfig.from_json(options.chaos_config),
            stats=service.fault_stats,
        )
        logger.warning("chaos-serve fault injection ACTIVE (testing)")
        try:
            with active(monkey):
                server.serve_forever()
        except KeyboardInterrupt:
            server.stop()
        finally:
            if capture is not None:
                capture.uninstall()
        return 0
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    finally:
        if capture is not None:
            capture.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
