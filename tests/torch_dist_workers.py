"""Spawned gloo worlds for the port's multi-rank tests, and the cases they
run. Kept apart from the test files, which import JAX: a spawned rank
imports the module that defines its function, and this one imports only
numpy, torch and the port.

``run_world(name, world, tmp, payload)`` starts ``world`` processes on
the CPU, each joining one gloo process group through a ``FileStore`` in
``tmp`` (no TCP port), running ``CASES[name](rank, world, payload)`` and
pickling what it returns. Every wait is bounded: the group's own timeout,
and the parent's join deadline, after which every rank is killed and the
call raises. Returns the per-rank results, by rank.
"""
import datetime
import os
import pickle
import time
import traceback

GROUP_TIMEOUT_S = 60


def _rank_main(rank, world, store_path, name, payload, out_dir):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    err = os.path.join(out_dir, f"rank{rank}.err")
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = CASES[name](rank, world, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A started world; :meth:`result` joins it (see ``run_world``)."""

    def __init__(self, name, world, tmp, payload, timeout_s):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.name, self.world = name, world
        self.out_dir = os.path.join(str(tmp), f"{name}_{world}")
        os.makedirs(self.out_dir, exist_ok=True)
        for f in os.listdir(self.out_dir):   # a fresh store: no stale keys
            os.remove(os.path.join(self.out_dir, f))
        store = os.path.join(self.out_dir, "store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, store, name, payload,
                                        self.out_dir), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout_s

    def result(self):
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > self.deadline:
                    break
                time.sleep(0.05)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in procs:
                p.join(timeout=10)
        errs = []
        for r in range(self.world):
            path = os.path.join(self.out_dir, f"rank{r}.err")
            if os.path.exists(path):
                errs.append(f"rank {r}:\n" + open(path).read())
        if errs or alive or any(p.exitcode != 0 for p in procs):
            why = ("timed out" if time.monotonic() > self.deadline
                   else "failed")
            raise RuntimeError(f"world {self.name!r} of {self.world} {why}:"
                               f" exit codes {[p.exitcode for p in procs]}"
                               "\n" + "\n".join(errs))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def start_world(name, world, tmp, payload=None, timeout_s=240) -> World:
    """Start the world and return at once (the caller's own work overlaps
    the ranks'); ``.result()`` joins it."""
    return World(name, world, tmp, payload, timeout_s)


def run_world(name, world, tmp, payload=None, timeout_s=240):
    return start_world(name, world, tmp, payload, timeout_s).result()


# ------------------------------------------------------------- helpers
def _np(t):
    import torch
    from paddle_tpu_torch.parallel.sharding import full_tensor
    if isinstance(t, (list, tuple)):
        return type(t)(_np(x) for x in t)
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if torch.is_tensor(t):
        # a copy: a replicated DTensor's full tensor aliases the live
        # parameter, which the optimizer updates in place
        return full_tensor(t).detach().float().cpu().numpy().copy()
    return t


def _jax_weights(model, params):
    """Load the JAX package's state dict (numpy) into a port model."""
    from paddle_tpu_torch.convert import load_jax_state_dict
    load_jax_state_dict(model, params)
    return model


def _gathered(x, axes):
    """This rank's local [b, s, ...] block gathered over the batch axes on
    dim 0 and sp on dim 1: the logical tensor, on every rank."""
    from paddle_tpu_torch.distributed import collective as C
    x = C._gather(x.contiguous(), "sp", 1) if "sp" in axes else x
    return C._gather(x.contiguous(), ("dp", "fsdp"), 0)


# --------------------------------------------------------- distributed
def distributed_cases(rank, world, p):
    """Collectives over {"dp": 2, "sp": 2}: values and gradients, the
    eager forms with a retried injected fault, fleet, the sampler's
    defaults under the mesh, degree-1 axes."""
    import torch
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.io import DistributedBatchSampler
    from paddle_tpu_torch.utils import faults
    out = {}
    mesh = D.init_parallel_env({"dp": 2, "sp": 2}, device="cpu")
    out["shape"] = dict(mesh.shape)
    out["sizes"] = {a: D.get_world_size(a) for a in D.HYBRID_AXES}
    out["coords"] = {a: D.get_rank(a) for a in ("dp", "sp", "tp")}
    x = torch.from_numpy(p["x"][rank]).requires_grad_()
    w = torch.from_numpy(p["w"][rank])
    red = {op: C.all_reduce(x.detach(), op, "sp")
           for op in ("sum", "max", "min", "avg")}
    red["prod"] = C.all_reduce(x.detach().abs() + 0.5, "prod", "sp")
    red["both"] = C.all_reduce(x.detach(), "sum", ("dp", "sp"))
    red["tp"] = C.all_reduce(x.detach(), "sum", "tp")
    out["reduce"] = _np(red)
    fwd = {"gather": C.all_gather(x, "sp", axis=1),
           "scatter": C.reduce_scatter(x, "sp", axis=1),
           "a2a": C.all_to_all(x, "sp", split_axis=2, concat_axis=1),
           "perm": C.ppermute(x, [(0, 1), (1, 0)], "sp"),
           "bcast": C.broadcast(x, 1, "sp")}
    out["fwd"] = _np(fwd)
    grads = {}
    for k, y in fwd.items():
        wk = torch.from_numpy(p["gw"][k][rank])
        (g,) = torch.autograd.grad((y * wk).sum(), x)
        grads[k] = g
    out["grads"] = _np(grads)
    out["axis"] = (C.axis_index("sp"), C.axis_size(("dp", "sp")))
    with faults.scoped("collective_fail@0"):
        out["eager"] = _np(C.eager_all_reduce(w, "sum", "dp"))
    out["eager_gather"] = _np(C.eager_all_gather(w, "sp"))
    out["eager_bcast"] = _np(C.eager_broadcast(w, 1, "dp"))
    os.environ["PADDLE_TPU_COLLECTIVE_RETRIES"] = "1"
    try:
        with faults.scoped("collective_fail@0"):
            C.eager_all_reduce(w, "sum", "dp")
        out["no_retry"] = "returned"
    except C.CollectiveError:
        out["no_retry"] = "raised"
    finally:
        del os.environ["PADDLE_TPU_COLLECTIVE_RETRIES"]
    s = DistributedBatchSampler(list(range(16)), 2)
    out["sampler"] = (s.nranks, s.local_rank, next(iter(s)))
    st = fleet.DistributedStrategy(hybrid_configs={"dp_degree": 2,
                                                   "sep_degree": 2})
    fleet.init(strategy=st, device="cpu")
    out["fleet"] = (dict(D.get_mesh().shape), fleet.worker_num(),
                    fleet.worker_index(), fleet.is_first_worker())
    env.clear_mesh()
    out["has_mesh"] = D.has_mesh()
    return out


# ------------------------------------------------------------- parallel
def _tiny_llama(seed, **overrides):
    import paddle_tpu_torch as ptt
    return ptt.LlamaForCausalLM(ptt.llama_tiny(**overrides), device="cpu",
                                generator=ptt.make_generator(seed, "cpu"))


def _trainer(model, batches, out_dir, steps, save_steps=0, loader=None,
             scaler=None, logging_steps=1):
    import paddle_tpu_torch as ptt
    opt = ptt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    args = ptt.TrainingArguments(output_dir=out_dir, max_steps=steps,
                                 logging_steps=logging_steps,
                                 save_steps=save_steps,
                                 prefetch_depth=0)
    return ptt.Trainer(model, opt, args,
                       train_dataloader=loader if loader is not None
                       else batches, scaler=scaler)


def _losses(tr):
    """(step, loss) of each logged step of this Trainer."""
    return list(tr.logger.history["loss"])


def _train(mesh_shape, p, out_dir, steps, stage=3, save_steps=0,
           loader=None, scaler=None, logging_steps=1):
    import torch
    from paddle_tpu_torch.distributed import fleet
    inv = {v: k for k, v in fleet.DistributedStrategy._DEGREE_TO_AXIS.items()}
    hybrid = {inv[a]: n for a, n in mesh_shape.items()}
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs=hybrid, sharding_stage=stage), device="cpu")
    model = _jax_weights(_tiny_llama(0, **p.get("cfg", {})), p["params"])
    fleet.distributed_model(model, fsdp_min_size=p["fsdp_min_size"])
    batches = [torch.from_numpy(b) for b in p["batches"]]
    tr = _trainer(model, batches, out_dir, steps, save_steps=save_steps,
                  loader=loader, scaler=scaler, logging_steps=logging_steps)
    tr.train()
    return tr, model


def parallel_cases(rank, world, p):
    """tp layers on {"dp": 2, "tp": 2}, fsdp placement on {"fsdp": 2,
    "tp": 2}, and the Trainer on {"fsdp": 2, "tp": 2} and {"dp": 2,
    "sp": 2} (3 steps), with a same-mesh resume."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)
    from paddle_tpu_torch.parallel.sharding import (param_shardings,
                                                    shard_layer)
    out = {}
    env.init_parallel_env({"dp": 2, "tp": 2}, device="cpu")
    gen = ptt.make_generator(1, "cpu")
    col = ColumnParallelLinear(16, 32, generator=gen, device="cpu")
    row = RowParallelLinear(32, 16, input_is_parallel=False, generator=gen,
                            device="cpu")
    emb = VocabParallelEmbedding(64, 16, generator=gen, device="cpu")
    col2 = ColumnParallelLinear(16, 64, gather_output=False, has_bias=False,
                                generator=gen, device="cpu")
    row2 = RowParallelLinear(64, 16, has_bias=False, generator=gen,
                             device="cpu")
    with torch.no_grad():
        for m, key in ((col, "col"), (row, "row"), (emb, "emb"),
                       (col2, "col2"), (row2, "row2")):
            for name, t in m.named_parameters():
                t.copy_(torch.from_numpy(p["layers"][key][name]))
    for m in (col, row, emb, col2, row2):
        shard_layer(m)
    x = torch.from_numpy(p["x"])
    ids = torch.from_numpy(p["ids"])
    out["col"] = _np(col(x))
    out["row"] = _np(row(torch.from_numpy(p["x32"])))
    out["emb"] = _np(emb(ids))
    # (after a forward, module.weight reads the compute tensor until
    # release(); the parameter is the DTensor in _parameters)
    out["col_local"] = tuple(col._parameters["weight"].to_local().shape)
    # this rank's rows of the batch (the gradients sum over dp); jax.nn.gelu's
    # default is the tanh form
    x_dp = x.chunk(2, dim=0)[env.get_rank("dp")]
    y = row2(torch.nn.functional.gelu(col2(x_dp), approximate="tanh"))
    g1, g2 = torch.autograd.grad((y ** 2).sum(),
                                 [col2._parameters["weight"],
                                  row2._parameters["weight"]])
    out["tp_grads"] = _np([g1, g2])
    # fsdp placement on the tiny Llama
    env.init_parallel_env({"fsdp": 2, "tp": 2}, device="cpu")
    model = _tiny_llama(0)
    out["shardings"] = {k: v.spec for k, v in param_shardings(
        model, fsdp_min_size=p["fsdp_min_size"]).items()}
    # the Trainer on two meshes, 3 steps, and a same-mesh resume
    base = p["out_dir"]
    for key, shape in (("fsdp_tp", {"fsdp": 2, "tp": 2}),
                       ("dp_sp", {"dp": 2, "sp": 2})):
        q = dict(p, cfg=p["cfgs"][key])
        tr, model = _train(shape, q, os.path.join(base, key, str(rank)),
                           steps=3)
        out[f"train_{key}"] = _losses(tr)
        out[f"params_{key}"] = {k: _np(v) for k, v in
                                model.named_parameters()}
    q = dict(p, cfg=p["cfgs"]["dp_sp"])
    shared = os.path.join(base, "resume")     # every rank: one directory
    tr, _ = _train({"dp": 2, "sp": 2}, q, shared, steps=2, save_steps=2)
    tr2, model = _train({"dp": 2, "sp": 2}, q, shared, steps=4,
                        save_steps=2)
    full, _ = _train({"dp": 2, "sp": 2}, q,
                     os.path.join(base, "full", str(rank)), steps=4)
    out["resume"] = (_losses(tr2), _losses(full))
    # a preemption notice on rank 1 alone, at step 1 of a run that logs
    # every 2 steps: the ranks agree at the boundary after step 2, all
    # checkpoint step 2 and exit with the preemption code
    import contextlib
    from paddle_tpu_torch.checkpoint.distributed_ckpt import \
        DistributedCheckpoint
    from paddle_tpu_torch.utils import faults
    shared = os.path.join(base, "preempt")
    notice = faults.scoped("preempt@1") if rank == 1 else \
        contextlib.nullcontext()
    try:
        with notice:
            _train({"dp": 2, "sp": 2}, q, shared, steps=4, logging_steps=2)
        out["preempt"] = ("finished",)
    except SystemExit as e:
        out["preempt"] = (e.code, DistributedCheckpoint(os.path.join(
            shared, "checkpoints")).latest_complete_step())
    # a GradScaler on {"fsdp": 2, "tp": 2}: at 2^15 the steps are the
    # unscaled run's; at 2^127 the scaled loss overflows, every rank
    # skips the step (its parameters unchanged) and halves the scale
    import paddle_tpu_torch as ptt
    q = dict(p, cfg=p["cfgs"]["fsdp_tp"])
    tr, _ = _train({"fsdp": 2, "tp": 2}, q,
                   os.path.join(base, "scaled", str(rank)), steps=3,
                   scaler=ptt.amp.GradScaler())
    out["scaled"] = _losses(tr)
    huge = ptt.amp.GradScaler(init_loss_scaling=2.0 ** 127)
    tr, model = _train({"fsdp": 2, "tp": 2}, q,
                       os.path.join(base, "overflow", str(rank)), steps=1,
                       scaler=huge)
    out["overflow"] = (float(tr._scaler_state["scale"]),
                       {k: _np(v) for k, v in model.named_parameters()})
    return out


def dp4_cases(rank, world, p):
    """On {"dp": world}: train to step p["steps"] with a save every 2
    steps over a global batch of p["batch"] rows, resuming the shared
    directory's latest step first (its restored parameters recorded)."""
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.io import DataLoader
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={"dp_degree": world}), device="cpu")
    model = _jax_weights(_tiny_llama(0), p["params"])
    fleet.distributed_model(model, fsdp_min_size=p["fsdp_min_size"])
    loader = DataLoader([torch.from_numpy(r) for r in p["rows"]],
                        batch_size=p["batch"])
    tr = _trainer(model, None, p["out_dir"], p["steps"], save_steps=2,
                  loader=loader)
    tr._opt_state = tr.optimizer.init(tr._trainable)
    restored = tr._try_resume()
    at_resume = {k: _np(v) for k, v in model.named_parameters()}
    tr.train()
    return {"losses": _losses(tr), "restored": restored,
            "at_resume": at_resume,
            "accum": tr.args.gradient_accumulation_steps,
            "meta": tr._ckpt_manager().load_meta(2),
            "params": {k: _np(v) for k, v in model.named_parameters()}}


# ----------------------------------------------------------------- ring
def ring_cases(rank, world, p):
    """ring / Ulysses / ring flash at sp = 4 (out and gradients), the
    masked delegation, and Llama with sequence_parallel on {"sp": 2,
    "dp": 2}."""
    import torch
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel.ring import (ring_attention,
                                                ring_flash_attention,
                                                ulysses_attention)
    out = {}
    env.init_parallel_env({"sp": 4}, device="cpu")
    fns = {"ring": ring_attention, "ulysses": ulysses_attention,
           "ring_flash": ring_flash_attention}
    for case in p["cases"]:
        q, k, v, go = (torch.from_numpy(a).chunk(world, dim=1)[rank]
                       .contiguous() for a in case["qkvg"])
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        kw = dict(causal=case["causal"])
        if case.get("window"):
            kw["window"] = case["window"]
        if case.get("seg") is not None:
            kw["segment_ids"] = torch.from_numpy(case["seg"]).chunk(
                world, dim=1)[rank].contiguous()
        o = fns[case["fn"]](q, k, v, "sp", **kw)
        grads = torch.autograd.grad((o * go).sum(), (q, k, v))
        out[case["name"]] = _np((o,) + grads)
    # Llama under sp on {"sp": 2, "dp": 2}
    env.init_parallel_env({"sp": 2, "dp": 2}, device="cpu")
    for name, cfg, seg in p["llama"]:
        model = _jax_weights(_tiny_llama(0, **cfg), p["params"][name])
        from paddle_tpu_torch.distributed import fleet
        fleet.distributed_model(model)
        ids = torch.from_numpy(p["ids"])
        ids_l = ids.chunk(2, dim=0)[env.get_rank("dp")].chunk(
            2, dim=1)[env.get_rank("sp")]
        kw = {}
        if seg is not None:
            kw["segment_ids"] = torch.from_numpy(seg).chunk(
                2, dim=0)[env.get_rank("dp")].chunk(
                2, dim=1)[env.get_rank("sp")]
        with torch.no_grad():
            logits = model(ids_l, **kw)
        out[f"llama_{name}"] = _np(_gathered(logits, ("dp", "sp")))
    return out


CASES = {"distributed": distributed_cases, "parallel": parallel_cases,
         "dp4": dp4_cases, "ring": ring_cases}
