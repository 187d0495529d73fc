"""Scenario flywheel: composable trace-driven workloads + a
deterministic chaos soak judged by the observability planes.

Copy of `karpenter_tpu/scenarios/`, on this package's Operator, real
client, kwok provider, planes and fault injector. `run_soak(spec,
device=...)` hands `device` to the Operator, so every solve of a soak
runs where its Operator runs (None: the card; raises without one).
`python -m karpenter_tpu_torch.scenarios` is the flywheel mode of the
JAX package's `tools/soak.py`, with `--device`.

Three pieces:

- **spec.py** — declarative scenario specs whose layers (diurnal
  serving waves, batch trains, demand surges, mixed-priority tenancy,
  expiry churn, spot-interruption storms) each compile to a pure
  function of (spec, seed, the injected clock origin): `compose()`
  emits a byte-identical pod/fault event schedule every run —
  extending the fault injector's replay-identity contract from fault
  LOGS to workload SCHEDULES (composed KARPENTER_FAULTS specs ride
  along with per-layer `#seed`s);
- **soak.py** — the long-horizon soak harness: replays a composed
  trace against the full reactive Operator (full ticks + micro-solves,
  crash-and-reboot on injected operator death) under accelerated
  injected time, with forced oracle audits on;
- **judge.py** — renders the structured verdict artifact, FAILING on
  SLO error-budget exhaustion, sentinel anomaly transitions, oracle
  divergence, unexplained-verdict drift against the spec's declared
  expectation envelope, or leaked claims/pods at trace end.

The planes do the judging — there are no hand-pinned walls here, so
every later change inherits this as its regression oracle.
"""

from karpenter_tpu_torch.scenarios.judge import judge
from karpenter_tpu_torch.scenarios.soak import run_soak
from karpenter_tpu_torch.scenarios.spec import (
    BatchTrain,
    DemandSurgeBurst,
    DiurnalWave,
    ExpectationEnvelope,
    ExpiryChurn,
    MixedTenancy,
    ScenarioSpec,
    Schedule,
    SpotStorm,
    compose,
    flywheel_spec,
    smoke_spec,
)

__all__ = [
    "BatchTrain",
    "DemandSurgeBurst",
    "DiurnalWave",
    "ExpectationEnvelope",
    "ExpiryChurn",
    "MixedTenancy",
    "ScenarioSpec",
    "Schedule",
    "SpotStorm",
    "compose",
    "flywheel_spec",
    "judge",
    "run_soak",
    "smoke_spec",
]
