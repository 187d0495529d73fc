"""Runnable operator binary: `python -m karpenter_tpu_torch`.

Copy of `karpenter_tpu/__main__.py`, with its flags and one more,
`--device`: the device of every solve (default: the card, "cuda"; "cpu"
for tests). Without a CUDA device and without `--device cpu` the binary
exits non-zero with the error: there is no fallback to the CPU.
`--solver-endpoint` raises `NotImplementedError` (the remote solver
service is ROADMAP item 8), as the resilience ladder's remote rung does.
`--state-file` saves and loads this package's own store.

Counterpart of kwok/main.go:29-51 — wire flags/env into Options, build
the kwok simulation provider over a store, construct the Operator with
the full controller set, mount observability, and run until signalled.

The store is the in-memory API server (kube/client.py) with optional
checkpoint persistence: `--state-file` loads existing state on boot
(the provider rehydrates its instances from claims, the
checkpoint/resume analogue) and saves on shutdown. A real-cluster
adapter can replace the store behind the same KubeClient interface.

Demo mode (`--demo N`) seeds a default NodePool and N pending pods so
a first run visibly provisions nodes and binds pods:

    python -m karpenter_tpu_torch --demo 50 --run-seconds 15 --log-level info
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    # flag names mirror pkg/operator/options/options.go:67-131; env
    # fallbacks use the reference's env names where they exist
    p = argparse.ArgumentParser(
        prog="karpenter_tpu_torch",
        description="GPU node autoscaler (kwok simulation provider)",
    )
    p.add_argument("--cluster-name",
                   default=os.environ.get("CLUSTER_NAME", "kwok-cluster"))
    p.add_argument("--metrics-port", type=int,
                   default=int(os.environ.get("METRICS_PORT", "8080")))
    p.add_argument("--metrics-bind-host",
                   default=os.environ.get("METRICS_BIND_HOST", "0.0.0.0"),
                   help="bind address for /metrics, /healthz, /readyz")
    p.add_argument("--batch-idle-duration", type=float, default=1.0)
    p.add_argument("--batch-max-duration", type=float, default=10.0)
    p.add_argument("--preference-policy", choices=("Respect", "Ignore"),
                   default="Respect")
    p.add_argument("--min-values-policy", choices=("Strict", "BestEffort"),
                   default="Strict")
    p.add_argument("--feature-gates",
                   default=os.environ.get("FEATURE_GATES", ""),
                   help='e.g. "SpotToSpotConsolidation=true,NodeRepair=true"')
    p.add_argument("--log-level", default=os.environ.get("LOG_LEVEL", "info"),
                   choices=("debug", "info", "warning", "error"))
    p.add_argument("--enable-profiling", action="store_true")
    p.add_argument("--leader-elect", action="store_true",
                   help="standby unless holding the lease (active/passive HA)")
    p.add_argument("--identity", default=os.environ.get("HOSTNAME", "karpenter-0"))
    p.add_argument("--registration-delay", type=float, default=0.0,
                   help="seconds a kwok instance takes to register as a Node")
    p.add_argument("--state-file", default="",
                   help="checkpoint path: load on boot, save on shutdown")
    p.add_argument("--api-server", default=os.environ.get("KUBE_API_SERVER", ""),
                   help="real API server URL; empty = in-memory store")
    p.add_argument("--api-token-file",
                   default=os.environ.get("KUBE_TOKEN_FILE", ""),
                   help="bearer token file for --api-server")
    p.add_argument("--api-ca-file", default=os.environ.get("KUBE_CA_FILE", ""),
                   help="CA bundle for --api-server TLS")
    p.add_argument("--solver-endpoint",
                   default=os.environ.get("KARPENTER_SOLVER_ENDPOINT", ""),
                   help="remote solver service (not ported: ROADMAP item 8); "
                        "empty = in-process")
    p.add_argument("--solver-shards", type=int,
                   default=int(os.environ.get("KARPENTER_SOLVER_SHARDS", "0") or 0))
    p.add_argument("--tick-seconds", type=float, default=1.0)
    p.add_argument("--run-seconds", type=float, default=0.0,
                   help="exit after this many seconds (0 = run forever)")
    p.add_argument("--demo", type=int, default=0, metavar="N",
                   help="seed a default NodePool and N pending demo pods")
    p.add_argument("--device", default="cuda",
                   help='device of every solve: "cuda" (the card, default) or "cpu"')
    return p


def seed_demo(kube, n_pods: int) -> None:
    from karpenter_tpu_torch.kube.objects import (
        Container, ObjectMeta, OwnerReference, Pod, PodSpec,
    )
    from karpenter_tpu_torch.apis.v1.nodepool import NodePool

    if kube.get_node_pool("default") is None:
        kube.create(NodePool(metadata=ObjectMeta(name="default")))
    for i in range(n_pods):
        name = f"demo-{i}"
        if kube.get_pod("default", name) is None:
            kube.create(Pod(
                metadata=ObjectMeta(name=name, owner_references=[
                    # ReplicaSet-owned so demo drains visibly reschedule
                    OwnerReference(kind="ReplicaSet", name="demo",
                                   uid="uid-demo-rs", controller=True),
                ]),
                spec=PodSpec(containers=[
                    Container(requests={"cpu": 1.0, "memory": 2.0 * 2**30})
                ]),
            ))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)-7s %(name)s %(message)s",
    )
    log = logging.getLogger("karpenter")

    if args.solver_endpoint:
        from karpenter_tpu_torch.solver.resilience import _REMOTE_MISSING

        raise NotImplementedError(_REMOTE_MISSING)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        # no card and no --device cpu: an error, never a move to the CPU
        log.error("no CUDA device is available for --device %s; pass --device cpu "
                  "to run the plain versions of the kernels", args.device)
        return 2
    if args.solver_shards:
        os.environ["KARPENTER_SOLVER_SHARDS"] = str(args.solver_shards)

    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.kube.client import KubeClient
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.operator.options import FeatureGates, Options

    options = Options(
        batch_idle_duration=args.batch_idle_duration,
        batch_max_duration=args.batch_max_duration,
        preference_policy=args.preference_policy,
        min_values_policy=args.min_values_policy,
        feature_gates=FeatureGates.parse(args.feature_gates),
        metrics_port=args.metrics_port,
        metrics_bind_host=args.metrics_bind_host,
        log_level=args.log_level,
        cluster_name=args.cluster_name,
        enable_profiling=args.enable_profiling,
    )

    if args.api_server:
        # real cluster: the adapter speaks CRs over HTTP with
        # resourceVersion conflict semantics (kube/real.py)
        from karpenter_tpu_torch.kube.real import HTTPTransport, RealKubeClient

        kube = RealKubeClient(HTTPTransport(
            args.api_server,
            token_file=args.api_token_file or None,
            ca_file=args.api_ca_file or None,
        ))
        log.info("connected to API server %s", args.api_server)
    elif args.state_file and os.path.exists(args.state_file):
        kube = KubeClient.load(args.state_file)
        log.info("state loaded from %s", args.state_file)
    else:
        kube = KubeClient()
    cloud = KwokCloudProvider(
        kube, registration_delay=args.registration_delay
    )
    restored = cloud.restore()
    if restored:
        log.info("rehydrated %d instances from the store", restored)

    operator = Operator(
        kube=kube,
        cloud_provider=cloud,
        options=options,
        identity=args.identity,
        leader_election=args.leader_elect,
        device=device,
    )
    if args.demo:
        seed_demo(kube, args.demo)
        log.info("demo: seeded default NodePool + %d pending pods", args.demo)

    stop = {"flag": False}

    def on_signal(signum, frame):
        log.info("signal %d: shutting down", signum)
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    server = operator.serve_observability()
    log.info(
        "operator up: cluster=%s provider=%s device=%s metrics=%s:%d",
        args.cluster_name, cloud.name(), device, args.metrics_bind_host, server.port,
    )
    try:
        operator.run(
            stop_after=args.run_seconds if args.run_seconds > 0 else None,
            tick_seconds=args.tick_seconds,
            should_stop=lambda: stop["flag"],
        )
    finally:
        if args.state_file and hasattr(kube, "save"):
            kube.save(args.state_file)
            log.info("state saved to %s", args.state_file)
        if hasattr(kube, "close"):
            kube.close()  # tear down watch-stream readers
    nodes = len(kube.nodes())
    bound = sum(1 for p in kube.pods() if p.spec.node_name)
    log.info("shutdown: %d nodes, %d bound pods", nodes, bound)
    return 0


if __name__ == "__main__":
    sys.exit(main())
