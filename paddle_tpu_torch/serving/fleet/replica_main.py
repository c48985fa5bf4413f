"""Standalone gateway replica process (counterpart of
``paddle_tpu/serving/fleet/replica_main.py``): the unit the fleet
manager spawns and the autoscaler scales.

    python -m paddle_tpu_torch.serving.fleet.replica_main \\
        --port 0 --model stub --chunk-tokens 8 [--device cpu]

Builds N engines (negligible-compute stub for harness runs, tiny llama
for real decode, Llama-3-8B at full width for the card), WARMS them
before announcing readiness (a cold first dispatch reads as a hang to
sub-second fleet probes: each engine runs a greedy and a sampled request
first, so its kernels are built and loaded and its greedy and sampled
tick graphs are captured before traffic), prints one
``FLEET_REPLICA_READY host=... port=...`` line to stdout, then serves
until SIGTERM drains it (``run_until_shutdown``). The engine geometry
here is the single source of truth the fleet loadgen's bitwise replay
gate rebuilds its reference engine from (:func:`stub_engine_kw`,
:func:`engine_kw`).

The engines run on the CUDA card unless ``--device cpu`` asks for the
CPU. A replica asked for the card on a machine without one, or whose
kernels fail to build or load, exits non-zero before its readiness line:
nothing falls back to the kernels' plain versions. Model weights are
drawn from ``--seed`` on the engines' device
(``LlamaForCausalLM(cfg, device=dev, generator=make_generator(seed,
dev))``), so a reference engine in another process built the same way
holds the same weights.
"""
from __future__ import annotations

import argparse
import asyncio
import sys
from typing import Any, Dict

__all__ = ["stub_engine_kw", "tiny_engine_kw", "llama3_8b_engine_kw",
           "engine_kw", "build_model", "build_engine", "main",
           "READY_LINE", "MODELS"]

READY_LINE = "FLEET_REPLICA_READY"
MODELS = ("stub", "tiny", "llama3-8b")


def stub_engine_kw(chunk_tokens: int = 8) -> Dict[str, Any]:
    """The stub-model engine geometry every fleet replica runs (and
    the loadgen's reference replay must match bit-for-bit)."""
    return dict(max_slots=4, num_blocks=128, block_size=8,
                max_blocks_per_seq=16, prefill_buckets=(16,),
                chunk_prefill_tokens=int(chunk_tokens),
                enable_prefix_cache=True)


def tiny_engine_kw(chunk_tokens: int = 32) -> Dict[str, Any]:
    return dict(max_slots=4, num_blocks=128, block_size=16,
                max_blocks_per_seq=16, prefill_buckets=(32,),
                chunk_prefill_tokens=int(chunk_tokens),
                enable_prefix_cache=True)


def llama3_8b_engine_kw(chunk_tokens: int = 128) -> Dict[str, Any]:
    """Llama-3-8B's serving geometry on one H100: 16 slots of up to
    1024 tokens over a pool of 1025 blocks of 16 (~2.15 GB of bf16 KV),
    chunked prefill, the prefix cache on."""
    return dict(max_slots=16, block_size=16, max_blocks_per_seq=64,
                num_blocks=1025, chunk_prefill_tokens=int(chunk_tokens),
                enable_prefix_cache=True)


def engine_kw(model: str, chunk_tokens: int) -> Dict[str, Any]:
    """The engine geometry of ``--model`` (one table for every caller)."""
    return {"stub": stub_engine_kw, "tiny": tiny_engine_kw,
            "llama3-8b": llama3_8b_engine_kw}[model](chunk_tokens)


def build_model(model: str, device=None, seed: int = 0):
    """``--model``'s weights on ``device`` (the card by default): the
    stub's seeded tables, or a Llama drawn from ``seed``."""
    from ...device import resolve_device
    dev = resolve_device(device)
    if model == "stub":
        from ...generation.stub import TickStubModel
        return TickStubModel(device=dev)
    from ...models import LlamaForCausalLM, llama3_8b, llama_tiny
    from ...utils.rng import make_generator
    cfg = {"tiny": llama_tiny, "llama3-8b": llama3_8b}[model]()
    return LlamaForCausalLM(cfg, device=dev,
                            generator=make_generator(seed, dev))


def build_engine(model: str, chunk_tokens: int, device=None,
                 seed: int = 0, weights=None):
    """One warmed engine: a greedy and a sampled request run before the
    readiness line, so the kernels are built and loaded and both tick
    graphs are captured here. ``weights``: a model to share (the
    replica's engines serve one set of weights)."""
    from ...generation.paged import PagedEngine
    from ..gateway import check_single_rank
    m = weights if weights is not None else build_model(model, device,
                                                        seed)
    eng = PagedEngine(m, **engine_kw(model, chunk_tokens))
    check_single_rank(eng, "replica_main")
    warm = list(range(1, 2 * int(chunk_tokens) + 2))
    eng.submit("warmup", warm, max_new_tokens=4)
    eng.run()
    eng.submit("warmup-sampled", warm, max_new_tokens=4,
               temperature=0.8, seed=1)
    eng.run()
    for k in ("warmup", "warmup-sampled"):
        eng.results.pop(k, None)
        eng.logprobs.pop(k, None)
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--model", default="stub", choices=MODELS)
    ap.add_argument("--chunk-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the engines' device (default: the CUDA card; "
                         "'cpu' asks for the CPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the Llama models' random weights")
    ap.add_argument("--engines", type=int, default=1,
                    help="replica engines inside this gateway (they "
                         "share one set of weights)")
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--name", default=None)
    ap.add_argument("--watchdog-timeout-s", type=float, default=30.0)
    ap.add_argument("--run-dir", default=None,
                    help="observability run dir: the gateway dumps "
                         "its request-trace rings (and its "
                         "series_<gw>.json trajectory) here on drain")
    ap.add_argument("--slo-window-scale", type=float, default=1.0,
                    help="scale the burn-rate alert windows "
                         "(loadgen --slo-windows pass-through; "
                         "<1 lets a CI-length run fire real alerts)")
    ap.add_argument("--telemetry", default="on",
                    choices=("on", "off"),
                    help="off = no sampler, no burn-rate alerting "
                         "(the A/B reference)")
    ap.add_argument("--spill-mb", type=int, default=0,
                    help="host-RAM KV spill arena capacity (MiB); "
                         "0 = no arena. An arena also makes this "
                         "replica's spilled spans fleet-fetchable over "
                         "GET /kvz")
    ap.add_argument("--migrate", default="off",
                    choices=("on", "off"),
                    help="on = SIGTERM drain CUTS live requests over "
                         "to the fleet (terminal migrated events + "
                         "resume_kv spans) instead of finishing "
                         "them here; requires --spill-mb > 0")
    ns = ap.parse_args(argv)

    from ...device import resolve_device
    from ...utils import observability as obs
    from .. import Gateway
    dev = resolve_device(ns.device)
    if ns.run_dir:
        obs.configure(ns.run_dir)
    shared = build_model(ns.model, dev, ns.seed)

    def factory():
        return build_engine(ns.model, ns.chunk_tokens, dev, ns.seed,
                            weights=shared)

    engines = [factory() for _ in range(max(ns.engines, 1))]
    telemetry_kw = dict(slo_window_scale=ns.slo_window_scale) \
        if ns.telemetry == "on" else \
        dict(sample_interval_s=None, slo_alerting=False)
    spill_kw: Dict[str, Any] = {}
    if ns.spill_mb > 0:
        from ..kvspill import KVSpillArena
        spill_kw["spill_arena"] = KVSpillArena(
            ns.spill_mb << 20, name=ns.name or "replica")
        spill_kw["migrate_on_drain"] = ns.migrate == "on"
    gw = Gateway(engines, host=ns.host, port=ns.port,
                 max_queue=ns.max_queue, name=ns.name,
                 engine_factory=factory,
                 watchdog_timeout_s=ns.watchdog_timeout_s,
                 **spill_kw, **telemetry_kw)

    async def serve():
        await gw.start()
        # the manager's readiness contract: one line, then serve
        print(f"{READY_LINE} host={gw.host} port={gw.port}",
              flush=True)
        await gw.run_until_shutdown()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
