"""Standalone gateway replica process (counterpart of
``paddle_tpu/serving/fleet/replica_main.py``): the unit the fleet
manager spawns and the autoscaler scales.

    python -m paddle_tpu_torch.serving.fleet.replica_main \\
        --port 0 --model stub --chunk-tokens 8 [--device cpu]

Builds N engines (negligible-compute stub for harness runs, tiny llama
for real decode, Llama-3-8B at full width for the card, ERNIE-4.5-21B-
A3B at full width for an MoE replica, its tiny config for the CPU tests),
WARMS them
before announcing readiness (a cold first dispatch reads as a hang to
sub-second fleet probes: each engine runs a greedy and a sampled request
first, so its kernels are built and loaded and its greedy and sampled
tick graphs are captured before traffic), prints one
``FLEET_REPLICA_READY host=... port=...`` line to stdout, then serves
until SIGTERM drains it (``run_until_shutdown``). The engine geometry
here is the single source of truth the fleet loadgen's bitwise replay
gate rebuilds its reference engine from (:func:`stub_engine_kw`,
:func:`engine_kw`).

A tensor-parallel replica is N rank processes, one engine each:

    python -m paddle_tpu_torch.distributed.launch --nproc N [--cpu] \\
        -m paddle_tpu_torch.serving.fleet.replica_main --tp N \\
        --model llama3-70b [--device cpu]

    python -m paddle_tpu_torch.distributed.launch --nproc N*M [--cpu] \\
        -m paddle_tpu_torch.serving.fleet.replica_main --tp N --ep M \\
        --model ernie45-21b-a3b [--device cpu]

serves an MoE model on a ``{"tp": N, "ep": M}`` mesh: attention and the
dense layer split over tp, each rank holding E / M of every MoE layer's
experts. Each rank draws the model from ``--seed`` inside
``sharded_build`` (no rank holds a decoder layer whole but the one being
drawn: the only way Llama-3-70B fits), shards and binds it, and wraps
its engine in a :class:`~..tp_replica.SequencedEngine`. Rank 0 warms every rank through
it, serves the gateway and prints the readiness line once every rank
has warmed both tick graphs; the other ranks follow rank 0's calls
until its drain stops them. ``--tp 1`` runs the same path as a world of
one.

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
import signal
import sys
from typing import Any, Dict, Optional

__all__ = ["stub_engine_kw", "tiny_engine_kw", "llama3_8b_engine_kw",
           "llama3_70b_engine_kw", "ernie_engine_kw", "engine_kw",
           "build_model", "build_sharded_model", "build_engine", "warm",
           "main", "READY_LINE", "MODELS"]

READY_LINE = "FLEET_REPLICA_READY"
MODELS = ("stub", "tiny", "llama3-8b", "llama3-70b", "ernie-tiny",
          "ernie45-21b-a3b")


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


def llama3_70b_engine_kw(chunk_tokens: int = 128) -> Dict[str, Any]:
    """Llama-3-70B's serving geometry: the 8B's (16 slots of up to 1024
    tokens, 1025 blocks of 16, chunk 128), so the two models' cells
    compare. At tp 4 a rank's KV is 80 layers x 2 x 2 heads x 128 x 2 B
    = 81,920 B a token: the pool takes ~1.34 GB a rank beside ~35 GB of
    weights."""
    return llama3_8b_engine_kw(chunk_tokens)


def ernie_engine_kw(chunk_tokens: int = 0,
                    tiny: bool = False) -> Dict[str, Any]:
    """An MoE model's geometry, with the JAX engine's settings for it:
    whole-prompt prefill (neither package chunk-prefills an MoE model),
    so no prefix cache. ERNIE-4.5-21B-A3B keeps the 8B's pool (16 slots
    of up to 1024 tokens, 1025 blocks of 16): 28 layers x 2 x 4 kv heads
    x 128 x 2 B = 57,344 B a token whole, ~0.94 GB of pool;
    ``chunk_tokens`` is unused. ``tiny``: the CPU tests' geometry."""
    if tiny:
        return dict(max_slots=4, num_blocks=128, block_size=16,
                    max_blocks_per_seq=16, prefill_buckets=(32,))
    return dict(max_slots=16, block_size=16, max_blocks_per_seq=64,
                num_blocks=1025)


def engine_kw(model: str, chunk_tokens: int) -> Dict[str, Any]:
    """The engine geometry of ``--model`` (one table for every caller)."""
    if model == "ernie-tiny":
        return ernie_engine_kw(chunk_tokens, tiny=True)
    return {"stub": stub_engine_kw, "tiny": tiny_engine_kw,
            "llama3-8b": llama3_8b_engine_kw,
            "llama3-70b": llama3_70b_engine_kw,
            "ernie45-21b-a3b": ernie_engine_kw}[model](chunk_tokens)


def _model_config(model: str, layers: Optional[int] = None):
    """(model class, config) of ``--model``, cut to ``layers`` decoder
    layers when given (``--layers``: a depth cut, widths kept)."""
    from ...models import (Ernie45MoeConfig, Ernie45MoeForCausalLM,
                           LlamaForCausalLM, ernie45_moe_tiny, llama3_8b,
                           llama3_70b, llama_tiny)
    over = {} if layers is None else dict(num_hidden_layers=int(layers))
    if model == "ernie45-21b-a3b":
        return Ernie45MoeForCausalLM, Ernie45MoeConfig(**over)
    if model == "ernie-tiny":
        return Ernie45MoeForCausalLM, ernie45_moe_tiny(**over)
    return LlamaForCausalLM, {"tiny": llama_tiny, "llama3-8b": llama3_8b,
                              "llama3-70b": llama3_70b}[model](**over)


def build_model(model: str, device=None, seed: int = 0,
                layers: Optional[int] = None):
    """``--model``'s weights on ``device`` (the card by default): the
    stub's seeded tables, or a model drawn from ``seed`` (``layers``: its
    depth cut)."""
    from ...device import resolve_device
    dev = resolve_device(device)
    if model == "stub":
        from ...generation.stub import TickStubModel
        return TickStubModel(device=dev)
    from ...utils.rng import make_generator
    cls, cfg = _model_config(model, layers)
    return cls(cfg, device=dev, generator=make_generator(seed, dev))


def build_sharded_model(model: str, seed: int = 0,
                        layers: Optional[int] = None):
    """``--model`` from ``seed`` on the installed mesh's device, each
    decoder layer cut to this rank's shards (tp, and an MoE layer's
    experts over ep) as it is drawn (``sharded_build``), the rest cut by
    ``shard_layer`` and the compute tensors bound once
    (``bind_static``): the weights that :func:`build_model` draws,
    sharded."""
    if model == "stub":
        raise ValueError("a tp replica serves a model (tiny, llama3-8b, "
                         "llama3-70b, ernie-tiny, ernie45-21b-a3b), not "
                         "the stub")
    from ...distributed.env import get_mesh
    from ...parallel.sharding import bind_static, shard_layer, sharded_build
    from ...utils.rng import make_generator
    dev = get_mesh().device
    cls, cfg = _model_config(model, layers)
    with sharded_build(fsdp_min_size=1 << 30):
        m = cls(cfg, device=dev, generator=make_generator(seed, dev))
    shard_layer(m, fsdp_min_size=1 << 30)
    bind_static(m)
    return m


def warm(engine, chunk_tokens: int):
    """Run a greedy and a sampled request through ``engine`` (a
    ``PagedEngine`` or a tp replica's sequenced one) and drop their
    records: its kernels are built and loaded and both tick graphs
    captured. Returns ``engine``."""
    w = list(range(1, 2 * int(chunk_tokens) + 2))
    engine.submit("warmup", w, max_new_tokens=4)
    engine.run()
    engine.submit("warmup-sampled", w, max_new_tokens=4, temperature=0.8,
                  seed=1)
    engine.run()
    for k in ("warmup", "warmup-sampled"):
        engine.results.pop(k, None)
        engine.logprobs.pop(k, None)
    return engine


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
    return warm(eng, chunk_tokens)


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
    ap.add_argument("--tp", type=int, default=None,
                    help="serve as one tp replica of N rank processes, "
                         "started by python -m paddle_tpu_torch."
                         "distributed.launch --nproc N (--cpu for gloo): "
                         "rank 0 serves, the others follow its calls")
    ap.add_argument("--ep", type=int, default=None,
                    help="--tp: split an MoE model's experts over M more "
                         "ranks (the launcher's --nproc N*M; the mesh "
                         "{tp: N, ep: M})")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many decoder layers (its "
                         "widths kept)")
    ap.add_argument("--idle-interval-s", type=float, default=None,
                    help="--tp: the idle rank 0's heartbeat to the other "
                         "ranks (default: tp_replica.IDLE_INTERVAL_S)")
    ns = ap.parse_args(argv)

    from ...utils import observability as obs
    from .. import Gateway
    spill_kw: Dict[str, Any] = {}
    if ns.spill_mb > 0:
        from ..kvspill import KVSpillArena
        spill_kw["spill_arena"] = KVSpillArena(
            ns.spill_mb << 20, name=ns.name or "replica")
        spill_kw["migrate_on_drain"] = ns.migrate == "on"
    if ns.ep is not None and ns.tp is None:
        raise SystemExit("--ep needs --tp: an ep replica is the tp ranks "
                         "times ep")
    if ns.tp is not None:
        seq = _tp_replica(ns, spill_kw.get("spill_arena"))
        if seq is None:
            return 0            # a follower rank: rank 0 stopped it
        engines, factory = [seq], seq.rebuild
        if ns.run_dir:
            obs.configure(ns.run_dir)
    else:
        from ...device import resolve_device
        dev = resolve_device(ns.device)
        if ns.run_dir:
            obs.configure(ns.run_dir)
        shared = build_model(ns.model, dev, ns.seed, ns.layers)

        def factory():
            return build_engine(ns.model, ns.chunk_tokens, dev, ns.seed,
                                weights=shared)

        engines = [factory() for _ in range(max(ns.engines, 1))]
    telemetry_kw = dict(slo_window_scale=ns.slo_window_scale) \
        if ns.telemetry == "on" else \
        dict(sample_interval_s=None, slo_alerting=False)
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
    if ns.tp is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def _tp_replica(ns, arena):
    """This rank of a ``--tp`` replica: the mesh, the sharded model and
    the sequenced engine. Rank 0 gets it back warmed on every rank; a
    follower rank follows rank 0's calls and gets None once stopped."""
    from ...distributed.env import init_parallel_env
    from ...generation.paged import PagedEngine
    from ..tp_replica import IDLE_INTERVAL_S, SequencedEngine
    if ns.engines != 1:
        raise SystemExit("--tp: a tp replica serves one engine")
    init_parallel_env({"tp": ns.tp, "ep": ns.ep or 1}, device=ns.device)
    model = build_sharded_model(ns.model, ns.seed, ns.layers)
    kw = engine_kw(ns.model, ns.chunk_tokens)

    def factory():
        # every rank rebuilds at the same point of the sequence, so
        # each warm-up's collectives meet
        return warm(PagedEngine(model, **kw), ns.chunk_tokens)

    seq = SequencedEngine(
        PagedEngine(model, **kw), factory=factory, spill_arena=arena,
        idle_interval_s=IDLE_INTERVAL_S if ns.idle_interval_s is None
        else ns.idle_interval_s)
    if not seq.leader:
        # rank 0 drains on SIGTERM and then stops this rank
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        seq.follow()
        import torch.distributed as dist
        dist.destroy_process_group()
        return None
    warm(seq, ns.chunk_tokens)
    seq.barrier()
    return seq


if __name__ == "__main__":
    sys.exit(main())
