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


# ------------------------------------------------------------- pipeline
def smoothed_ce(logits, labels, eps=0.1):
    """A custom loss head (the JAX package's test's label smoothing)."""
    import torch
    v = logits.shape[-1]
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = torch.nn.functional.one_hot(labels[:, 1:], v) * (1 - eps) + eps / v
    return -(tgt * lp).sum(dim=-1).mean()


def _pp_model(kind, cfg, params):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import models
    if kind == "moe":
        m = models.Qwen2MoeForCausalLM(models.qwen2_moe_tiny(**cfg),
                                       device="cpu")
    else:
        m = ptt.LlamaForCausalLM(ptt.llama_tiny(**cfg), device="cpu")
    return _jax_weights(m, params)


def _fleet(mesh_shape, stage=1):
    from paddle_tpu_torch.distributed import fleet
    inv = {v: k for k, v in fleet.DistributedStrategy._DEGREE_TO_AXIS.items()}
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={inv[a]: n for a, n in mesh_shape.items()},
        sharding_stage=stage), device="cpu")


def _rows(x, dim=0):
    """This rank's rows of a global array over dp x fsdp."""
    import torch
    from paddle_tpu_torch.distributed import env
    deg, coord = env.batch_coordinates()
    return torch.from_numpy(x).chunk(deg, dim=dim)[coord].contiguous()


def pp_value_and_grad(model, tokens, pp, vpp=1, logits_loss=None):
    """What the Trainer's pipeline step computes before the update: the
    loss (summed over the data axes) and every parameter's whole
    gradient, as numpy."""
    from paddle_tpu_torch.parallel.pipeline import pipeline_grads
    vag = model.pipeline_functional(pp, logits_loss=logits_loss, vpp=vpp)
    loss, g = pipeline_grads(model, vag, tokens)
    return float(loss), {k: _np(v) for k, v in g.items()}


def _pp_trainer(mesh_shape, p, out_dir, steps, save_steps=0, vpp=1,
                accum=2):
    import torch
    import paddle_tpu_torch as ptt
    _fleet(mesh_shape)
    model = _pp_model("llama", p["cfg"], p["params"]["trainer"])
    from paddle_tpu_torch.distributed import fleet
    fleet.distributed_model(model, fsdp_min_size=1 << 30)
    opt = ptt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    args = ptt.TrainingArguments(output_dir=out_dir, max_steps=steps,
                                 logging_steps=1, save_steps=save_steps,
                                 prefetch_depth=0, virtual_pp_degree=vpp,
                                 gradient_accumulation_steps=accum)
    tr = ptt.Trainer(model, opt, args, train_dataloader=[
        torch.from_numpy(b) for b in p["batches"]])
    tr.train()
    return tr, model


def pipeline_cases(rank, world, p):
    """pipeline_functional's loss and gradients on the cases of the JAX
    package's tests/test_pipeline_1f1b.py, the pp path's refusals, the
    Trainer's pp and vpp steps, and a resume from {"pp": 2, "dp": 2}
    onto {"dp": 4}."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env, fleet
    out = {}
    for c in p["cases"]:
        _fleet(c["mesh"])
        model = _pp_model(c["kind"], c["cfg"], p["params"][c["params"]])
        fleet.distributed_model(model, fsdp_min_size=1 << 30)
        loss_head = smoothed_ce if c.get("smooth") else None
        out[c["name"]] = pp_value_and_grad(
            model, _rows(c["tokens"], dim=1), c["mesh"]["pp"],
            c.get("vpp", 1), loss_head)
    # the GPipe forward, and the refusals of the Trainer's pp path
    _fleet({"pp": 2, "dp": 2})
    from paddle_tpu_torch.parallel import pipeline_apply
    out["apply"] = _np(pipeline_apply(
        lambda prm, x: torch.tanh(x @ prm["w"]),
        {"w": torch.from_numpy(p["apply"][0])},
        torch.from_numpy(p["apply"][1])))
    refusals = {}
    for key in ("frozen", "scaler", "loss_fn", "dict"):
        model = _pp_model("llama", p["cfg"], p["params"]["trainer"])
        kw = {}
        if key == "frozen":
            model.model.embed_tokens.weight.requires_grad_(False)
        if key == "scaler":
            kw["scaler"] = ptt.amp.GradScaler()
        if key == "loss_fn":
            kw["loss_fn"] = lambda m, b: m(b).sum()
        batches = [{"input_ids": torch.zeros(2, 16, dtype=torch.long)}] \
            if key == "dict" else [torch.zeros(2, 16, dtype=torch.long)]
        tr = ptt.Trainer(model, ptt.optimizer.SGD(), ptt.TrainingArguments(
            output_dir=os.path.join(p["out_dir"], "refuse", str(rank)),
            max_steps=1, prefetch_depth=0), train_dataloader=batches, **kw)
        try:
            tr.train()
            refusals[key] = None
        except (ValueError, TypeError) as e:
            refusals[key] = (type(e).__name__, str(e))
    out["refusals"] = refusals
    # the Trainer, 3 steps, 1F1B (saving step 2 for the resume below)
    # and interleaved
    shared = os.path.join(p["out_dir"], "resume")
    for vpp in (1, 2):
        tr, model = _pp_trainer(
            {"pp": 2, "dp": 2}, p, shared if vpp == 1 else os.path.join(
                p["out_dir"], f"vpp{vpp}", str(rank)), 3,
            save_steps=2 if vpp == 1 else 0, vpp=vpp)
        out[f"train_vpp{vpp}"] = (_losses(tr), {
            k: _np(v) for k, v in model.named_parameters()})
    # resume the 1F1B run's step 2 on {"dp": 4}
    env.clear_mesh()
    tr, model = _pp_trainer({"dp": 4}, p, shared, 4, save_steps=2)
    out["resume"] = (_losses(tr), tr.args.gradient_accumulation_steps,
                     {k: _np(v) for k, v in model.named_parameters()})
    return out


# ------------------------------------------------------------------- ep
def _family(kind, cfg, params):
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import deepseek_v2 as ds
    if kind == "deepseek":
        m = ds.DeepseekV2ForCausalLM(ds.deepseek_v2_tiny(**cfg), device="cpu")
    else:
        m = models.Qwen2MoeForCausalLM(models.qwen2_moe_tiny(**cfg),
                                       device="cpu")
    return _jax_weights(m, params)


def family_loss(kind):
    """The training objective of ``kind``: moe_lm_loss for Qwen2-MoE,
    deepseek_mtp_loss for DeepSeek-V2 with its MTP module."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import deepseek_v2 as ds
    if kind == "deepseek":
        return lambda m, b: ds.deepseek_mtp_loss(*m(b, return_mtp=True), b,
                                                 weight=0.1)
    return lambda m, b: models.moe_lm_loss(*m(b, return_aux=True), b)


def family_trainer(kind, cfg, params, batches, out_dir, steps,
                   save_steps=0):
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env, fleet
    model = _family(kind, cfg, params)
    if env.has_mesh():
        fleet.distributed_model(model, fsdp_min_size=1 << 30)
    opt = ptt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    args = ptt.TrainingArguments(output_dir=out_dir, max_steps=steps,
                                 logging_steps=1, save_steps=save_steps,
                                 prefetch_depth=0)
    tr = ptt.Trainer(model, opt, args, loss_fn=family_loss(kind),
                     train_dataloader=[torch.from_numpy(b)
                                       for b in batches])
    tr.train()
    return _losses(tr), {k: _np(v) for k, v in model.named_parameters()}


def ep_cases(rank, world, p):
    """MoEMLP on {"ep": 2, "dp": 2} (output, aux, every gradient, the
    routing, the local expert shards); Qwen2-MoE and DeepSeek-V2 forward
    on {"dp": 2, "tp": 2}; the Trainer, 3 steps, with moe_lm_loss on
    {"ep": 2, "dp": 2} (saving step 2) and deepseek_mtp_loss on {"dp": 2,
    "tp": 2}."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.parallel.moe import MoEMLP, top_k_routing
    from paddle_tpu_torch.parallel.sharding import shard_layer
    out = {}
    _fleet({"ep": 2, "dp": 2})
    mlp = MoEMLP(**p["mlp_kw"], generator=ptt.make_generator(0, "cpu"),
                 device="cpu")
    with torch.no_grad():
        for name, t in mlp.named_parameters():
            t.copy_(torch.from_numpy(p["mlp"][name]))
    shard_layer(mlp, fsdp_min_size=1 << 30)
    x = _rows(p["x"]).requires_grad_(True)
    y, aux = mlp(x, return_aux=True)
    n = env.axis_degree(env.BATCH_AXES)
    obj = (y * _rows(p["go"])).sum() + aux / n
    params = dict(mlp.named_parameters())
    grads = torch.autograd.grad(obj, [x] + list(params.values()))
    out["mlp"] = dict(
        y=_np(_gathered(y, ())), aux=float(aux),
        dx=_np(_gathered(grads[0], ())),
        grads={k: _np(g) for k, g in zip(params, grads[1:])},
        local={k: tuple(v.to_local().shape) for k, v in params.items()})
    with torch.no_grad():
        xg = C._gather(x.detach(), ("dp", "fsdp"), 0).reshape(-1, 32)
        logits = xg.float() @ mlp.gate.float()
        dispatch, _, _ = top_k_routing(
            logits, mlp.top_k, mlp.capacity(xg.shape[0]))
    out["dispatch"] = _np(dispatch)
    # the families' forward on {"dp": 2, "tp": 2}
    _fleet({"dp": 2, "tp": 2})
    for kind in ("qwen", "deepseek"):
        model = _family(kind, p["cfgs"][kind], p["params"][kind])
        fleet.distributed_model(model, fsdp_min_size=1 << 30)
        with torch.no_grad():
            logits = model(_rows(p["ids"]))
        out[f"fwd_{kind}"] = _np(_gathered(logits, ()))
    # the Trainer (the Qwen2-MoE run saves step 2 for a resume)
    for kind, mesh in (("qwen", {"ep": 2, "dp": 2}),
                       ("deepseek", {"dp": 2, "tp": 2})):
        _fleet(mesh)
        qwen = kind == "qwen"
        out[f"train_{kind}"] = family_trainer(
            kind, p["cfgs"][kind], p["params"][kind], p["batches"],
            os.path.join(p["out_dir"], "resume") if qwen else
            os.path.join(p["out_dir"], kind, str(rank)), 3,
            save_steps=2 if qwen else 0)
    return out


CASES = {"distributed": distributed_cases, "parallel": parallel_cases,
         "dp4": dp4_cases, "ring": ring_cases, "pipeline": pipeline_cases,
         "ep": ep_cases}


# ---------------------------------------------------------- tp serving
def _tp_model(cfg_kw, params, family="llama"):
    """A port model of the tiny family config ``cfg_kw`` holding the JAX
    weights ``params``."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import qwen2_tiny
    cfg = (ptt.llama_tiny if family == "llama" else qwen2_tiny)(**cfg_kw)
    cls = ptt.LlamaForCausalLM if family == "llama" else \
        ptt.models.Qwen2ForCausalLM
    return _jax_weights(cls(cfg, device="cpu"), params)


def _serve(model):
    """Shard ``model`` over the mesh's tp (tp rules only) and bind its
    compute tensors once."""
    from paddle_tpu_torch.parallel.sharding import bind_static, shard_layer
    shard_layer(model, fsdp_min_size=1 << 30)
    bind_static(model)
    return model


def _tp_scenario(model, p, out, tag, **engine_kw):
    """The JAX package's ``_dryrun_paged_tp`` scenario on this rank's
    engine: "a" finishes and parks its prefix, "b" adopts it, "s" is
    sampled beside it."""
    import numpy as np
    from paddle_tpu_torch.generation.paged import PagedEngine
    eng = PagedEngine(model, max_slots=2, num_blocks=24, block_size=8,
                      max_blocks_per_seq=6, prefill_buckets=(16,),
                      chunk_prefill_tokens=8, enable_prefix_cache=True,
                      **engine_kw)
    # count the schedule digests the engine's cross-rank check takes
    digests = [0]
    digest = eng.schedule_digest

    def counted():
        digests[0] += 1
        return digest()
    eng.schedule_digest = counted
    eng.submit("a", np.asarray(p["prompts"]["a"]), max_new_tokens=8)
    res = dict(eng.run())
    eng.submit("b", np.asarray(p["prompts"]["b"]), max_new_tokens=8)
    eng.submit("s", np.asarray(p["sampled"]), max_new_tokens=8,
               temperature=0.8, top_p=0.9, seed=5)
    res.update(eng.run())
    out[f"{tag}_streams"] = {k: list(v) for k, v in res.items()}
    out[f"{tag}_stats"] = dict(eng.stats)
    out[f"{tag}_pools"] = tuple(eng.pools[0][0].shape)
    out[f"{tag}_digests"] = digests[0]
    return eng


def tp_serving_cases(rank, world, p):
    """tp serving on {"tp": world}: the ``_dryrun_paged_tp`` scenario
    (plain and speculative ticks), ``generate()`` greedy, sampled and
    beam, fused projections, ``Predictor`` at int8 and int4, the
    quantized tp layers, and the refusals. Every eager collective a
    serving program reaches is counted."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.nn.fuse import fuse_projections
    from paddle_tpu_torch.parallel.sharding import local
    out = {}
    eager = []
    real_eager = C._eager

    def counting(fn, x, group):
        eager.append(str(group))
        return real_eager(fn, x, group)
    C._eager = counting
    env.init_parallel_env({"tp": world}, device="cpu")
    model = _serve(_tp_model(p["cfg"], p["params"]))
    # the compute tensors are the local shards themselves
    attn = model.model.layers[0].self_attn
    w = attn.q_proj._parameters["weight"]
    out["alias"] = attn.q_proj.weight.data_ptr() == local(w).data_ptr()
    out["q_local"] = tuple(attn.q_proj.weight.shape)
    # each rank keeps its shards alone: no local tensor holds the full
    # storage it was cut from
    out["own_storage"] = all(
        local(p).untyped_storage().nbytes()
        == local(p).numel() * local(p).element_size()
        for p in model.parameters())
    out["cache_heads"] = model.init_kv_caches(1, 4)[0][0].shape[2]
    ids = torch.from_numpy(np.asarray(p["prompts"]["b"]))
    with torch.no_grad():
        out["logits"] = model(ids).numpy()
    out["greedy"] = ptt.generate(model, ids, max_new_tokens=8).numpy()
    out["beam"] = ptt.generate(model, ids, max_new_tokens=6,
                               num_beams=3).numpy()
    out["sampled"] = ptt.generate(
        model, ids, max_new_tokens=8, do_sample=True, temperature=0.8,
        top_k=20, generator=ptt.make_generator(3, "cpu")).numpy()
    _tp_scenario(model, p, out, "paged")
    _tp_scenario(model, p, out, "spec", spec_tokens=4)
    out["eager_serving"] = list(eager)
    # a model built in sharded_build (each decoder layer cut to this
    # rank's shards as it is drawn) is the whole built model sharded
    from paddle_tpu_torch.parallel.sharding import is_sharded, sharded_build
    cfg = ptt.llama_tiny(**p["cfg"])
    whole = _serve(ptt.LlamaForCausalLM(
        cfg, device="cpu", generator=ptt.make_generator(11, "cpu")))
    with sharded_build(fsdp_min_size=1 << 30):
        built = ptt.LlamaForCausalLM(
            cfg, device="cpu", generator=ptt.make_generator(11, "cpu"))
    out["built_sharded"] = (
        all(is_sharded(q) for q in built.model.layers.parameters()),
        is_sharded(built.model.embed_tokens.weight))
    _serve(built)
    out["built_same"] = all(torch.equal(local(a), local(b)) for a, b in zip(
        whole.parameters(), built.parameters()))
    with torch.no_grad():
        out["built_logits_same"] = torch.equal(whole(ids), built(ids))
    # fused projections on the sharded model: this rank's fused shard and
    # the logits
    fuse_projections(model)
    out["fused_qkv_local"] = model.model.layers[0].self_attn.qkv_proj \
        .weight.numpy().copy()
    with torch.no_grad():
        out["fused_logits"] = model(ids).numpy()
    out["fused_greedy"] = ptt.generate(model, ids, max_new_tokens=8).numpy()
    # Qwen2's biased q/k/v through the fused interleave
    qwen = _serve(_tp_model(p["qwen_cfg"], p["qwen_params"], "qwen2"))
    fuse_projections(qwen)
    with torch.no_grad():
        out["qwen_fused_logits"] = qwen(ids).numpy()
        out["qwen_fused_bias"] = qwen.model.layers[0].self_attn.qkv_proj \
            .bias.numpy().copy()
    # Predictor at int8 and int4 (cast, quantize with the tp metadata,
    # fuse), and the codes each rank holds
    qids = torch.from_numpy(np.asarray(p["qids"]))
    for bits in (8, 4):
        m = _serve(_tp_model(p["qcfg"], p["qparams"]))
        pred = ptt.Predictor(m, ptt.Config().enable_weight_only_quant(bits),
                             device="cpu")
        lyr = m.model.layers[0]
        out[f"q{bits}_codes"] = {
            "q_proj": tuple(lyr.self_attn.q_proj.qweight.shape),
            "o_proj": tuple(lyr.self_attn.o_proj.qweight.shape),
            "o_scales": tuple(lyr.self_attn.o_proj.scales.shape),
            "down_proj": tuple(lyr.mlp.down_proj.qweight.shape)}
        out[f"q{bits}_logits"] = pred.run(qids).numpy()
        out[f"q{bits}_greedy"] = pred.generate(qids,
                                               max_new_tokens=6).numpy()
    m = _serve(_tp_model(p["qcfg"], p["qparams"]))
    pred = ptt.Predictor(m, ptt.Config().enable_weight_only_quant(8),
                         device="cpu")
    fuse_projections(pred.model)
    out["q8_fused_logits"] = pred.run(qids).numpy()
    out.update(_quant_layer_cases(p, world))
    out.update(_refusals(p, world))
    C._eager = real_eager
    return out


def _quant_layer_cases(p, world):
    """The quantized tp layers: a gathered column layer quantized whole
    then sharded equals the dense quantized layer (the JAX test_quant
    case); a row layer's codes split on in read their blocks of the whole
    scales table; a row split off the 128-row blocks raises."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           RowParallelLinear)
    from paddle_tpu_torch.parallel.sharding import shard_layer
    from paddle_tpu_torch.quant import QuantizedLinear, linear_quant_meta
    out = {}
    gen = ptt.make_generator(7, "cpu")
    x = torch.from_numpy(p["qx"])
    col = ColumnParallelLinear(128, 64, gather_output=True, generator=gen,
                               device="cpu")
    q = QuantizedLinear.from_linear(col, bits=8)
    ref = q(x)
    shard_layer(q)
    out["col_dense"] = (ref.numpy(), q(x).numpy(), tuple(q.qweight.shape))
    for bits in (8, 4):
        row = RowParallelLinear(256, 64, input_is_parallel=False,
                                has_bias=True, generator=gen, device="cpu")
        with torch.no_grad():
            row.bias.normal_(generator=gen)
        meta = linear_quant_meta(row)
        q = QuantizedLinear.from_linear(row, bits=bits)
        ref = q(x.repeat(1, 2))
        shard_layer(q)
        out[f"row{bits}"] = (ref.numpy(), q(x.repeat(1, 2)).numpy(),
                             tuple(q.qweight.shape), tuple(q.scales.shape),
                             meta)
        # quantized after sharding: the same codes, the scales gathered
        row2 = RowParallelLinear(256, 64, input_is_parallel=False,
                                 generator=ptt.make_generator(9, "cpu"),
                                 device="cpu")
        whole = QuantizedLinear.from_linear(row2, bits=bits)
        shard_layer(row2)
        part = QuantizedLinear.from_linear(row2, bits=bits)
        n = whole.qweight.shape[0] // world
        r = torch.distributed.get_rank()
        out[f"row{bits}_after"] = (
            torch.equal(part.qweight, whole.qweight[r * n:(r + 1) * n]),
            torch.equal(part.scales, whole.scales))
    # a row split of 128 / tp rows cuts a scale block
    bad = RowParallelLinear(128, 64, generator=gen, device="cpu")
    q = QuantizedLinear.from_linear(bad, bits=8)
    try:
        shard_layer(q)
        out["row_indivisible"] = None
    except ValueError as e:
        out["row_indivisible"] = str(e)
    shard_layer(bad)
    try:
        QuantizedLinear.from_linear(bad, bits=8)
        out["row_indivisible_after"] = None
    except ValueError as e:
        out["row_indivisible_after"] = str(e)
    return out


def _refusals(p, world):
    """An MoE model on the tp mesh serves (its generate() and engine
    streams, for the caller to hold to the whole model's); a gateway over
    a bare tp engine is refused; a gateway over rank 0's sequenced engine
    builds, over a follower's it is refused; a schedule that parts across
    the ranks raises on every rank."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM, qwen2_moe_tiny
    from paddle_tpu_torch.serving.gateway import Gateway
    out = {}
    moe = _serve(Qwen2MoeForCausalLM(qwen2_moe_tiny(), device="cpu"))
    ids = torch.ones(1, 4, dtype=torch.int64)
    out["moe_generate"] = ptt.generate(moe, ids, max_new_tokens=2).numpy()
    eng = PagedEngine(moe, max_slots=2)       # a tick's rows route dropless
    eng.submit("m", ids[0].numpy(), max_new_tokens=2)
    out["moe_engine"] = list(eng.run()["m"])
    model = _serve(_tp_model(p["cfg"], p["params"]))
    eng = PagedEngine(model, max_slots=2, num_blocks=16, block_size=8,
                      max_blocks_per_seq=4, prefill_buckets=(16,))
    try:
        Gateway(eng)
        out["gateway"] = None
    except NotImplementedError as e:
        out["gateway"] = str(e)
    from paddle_tpu_torch.serving.tp_replica import SequencedEngine
    seq = SequencedEngine(eng, idle_interval_s=None)
    try:
        Gateway(seq)
        out["gateway_sequenced"] = "built"
    except ValueError as e:
        out["gateway_sequenced"] = str(e)
    # rank 0 submits 5 prompt tokens, the others 6: one prefill bucket,
    # so every collective matches, and the digest parts
    rank = torch.distributed.get_rank()
    eng.submit("x", np.arange(1, 6 if rank == 0 else 7), max_new_tokens=2)
    try:
        eng.run()
        out["diverge"] = None
    except RuntimeError as e:
        out["diverge"] = str(e)
    return out


def tp4_serving_cases(rank, world, p):
    """tp 4: one kv head a rank; the fused interleave at T = 4 through
    generate() and the engine."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.nn.fuse import fuse_projections
    out = {}
    env.init_parallel_env({"tp": world}, device="cpu")
    model = _serve(_tp_model(p["cfg"], p["params"]))
    out["cache_heads"] = model.init_kv_caches(1, 4)[0][0].shape[2]
    ids = torch.from_numpy(np.asarray(p["prompts"]["b"]))
    out["greedy"] = ptt.generate(model, ids, max_new_tokens=8).numpy()
    fuse_projections(model)
    out["fused_qkv_local"] = model.model.layers[0].self_attn.qkv_proj \
        .weight.numpy().copy()
    out["fused_greedy"] = ptt.generate(model, ids, max_new_tokens=8).numpy()
    eng = PagedEngine(model, max_slots=2, num_blocks=24, block_size=8,
                      max_blocks_per_seq=6, prefill_buckets=(16,),
                      chunk_prefill_tokens=8, enable_prefix_cache=True)
    eng.submit("b", np.asarray(p["prompts"]["b"]), max_new_tokens=8)
    out["paged"] = list(eng.run()["b"])
    out["pools"] = tuple(eng.pools[0][0].shape)
    return out


CASES.update(tp_serving=tp_serving_cases, tp4_serving=tp4_serving_cases)


# ------------------------------------------------------ tp gateway
# the _dryrun_paged_tp engine geometry; FAULT_GEO holds 48 tokens a slot,
# SPILL_GEO a pool of 11 blocks that parked prefixes must leave
TP_GEO = dict(max_slots=2, num_blocks=24, block_size=8,
              max_blocks_per_seq=6, prefill_buckets=(16,),
              chunk_prefill_tokens=8, enable_prefix_cache=True)
SPILL_GEO = dict(TP_GEO, num_blocks=12)


def _direct_streams(eng, batches):
    """Each batch's submissions run to the end on ``eng``; (tokens,
    logprobs) by request id."""
    import numpy as np
    out = {}
    for batch in batches:
        for rid, ids, kw in batch:
            eng.submit(rid, np.asarray(ids), **kw)
        eng.run()
        for rid, _, _ in batch:
            out[rid] = (list(eng.results.pop(rid)),
                        list(eng.logprobs.pop(rid)))
    return out


def _sequenced_world(model, geo, leader_fn, **seq_kw):
    """One scenario on every rank: a fresh engine behind a
    ``SequencedEngine``; rank 0 serves it through ``leader_fn(seq)``
    (which drains its gateway, stopping the followers), the others
    follow. Returns this rank's record: the leader's result or the
    follower's stats and kept streams, and the engine's counters."""
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving.tp_replica import SequencedEngine
    seq = SequencedEngine(PagedEngine(model, **geo), **seq_kw)
    rec = {}
    if seq.leader:
        rec["leader"] = leader_fn(seq)
    else:
        keep = {}
        rec["follow"] = seq.follow(keep)
        rec["keep"] = keep
    rec["stats"] = dict(seq.engine.stats)
    rec["seq"] = seq.sequencer_stats()
    return rec


def tp_gateway_cases(rank, world, p):
    """tp serving behind the gateway on {"tp": world}: the parity
    scenario (``_dryrun_paged_tp``'s requests over HTTP) beside the same
    submissions on a direct tp engine; at tp 2 also a disconnect, a
    cancel, a deadline mid-stream, an idle gap, a hang on rank 0 that
    the supervisor answers with a sequenced hard_reset, and a span
    spilled and restored on every rank."""
    import asyncio
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.generation.paged import PagedEngine
    env.init_parallel_env({"tp": world}, device="cpu")
    model = _serve(_tp_model(p["cfg"], p["params"]))
    reqs = p["gw_reqs"]
    out = {"direct": _direct_streams(
        PagedEngine(model, **TP_GEO),
        [[(r["request_id"], r["prompt"], _engine_kw(r)) for r in batch]
         for batch in reqs])}
    out["parity"] = _sequenced_world(
        model, TP_GEO, lambda seq: asyncio.run(_gw_parity(seq, reqs)),
        idle_interval_s=0.2)
    if world > 2:
        return out
    fresh = PagedEngine(model, **TP_GEO)
    out["fresh"] = _direct_streams(fresh, [[(
        "g", p["late"]["prompt"], _engine_kw(p["late"]))]])
    out["faults"] = _sequenced_world(
        model, TP_GEO, lambda seq: asyncio.run(_gw_faults(seq, p)),
        idle_interval_s=0.2)
    from paddle_tpu_torch.serving import KVSpillArena
    out["spill"] = _sequenced_world(
        model, SPILL_GEO, lambda seq: asyncio.run(_gw_spill(seq, p)),
        idle_interval_s=0.2, spill_arena=KVSpillArena(1 << 22))
    return out


def _engine_kw(r):
    return {k: v for k, v in r.items()
            if k not in ("prompt", "request_id", "stream")}


async def _gw_parity(seq, reqs):
    """The requests over HTTP SSE, batch after batch (a finishes and
    parks its prefix; b adopts it beside the sampled s); drain."""
    import asyncio
    from paddle_tpu_torch.serving import Gateway
    from test_torch_gateway_gpu import sse
    gw = Gateway(seq, name=f"tp-parity-{seq.tp}")
    await gw.start()
    got = {}
    try:
        for batch in reqs:
            res = await asyncio.gather(*[sse(gw.port, r) for r in batch])
            for r, (st, _, toks, fin) in zip(batch, res):
                got[r["request_id"]] = (st, toks, fin)
    finally:
        await gw.drain()
    return got


async def _gw_faults(seq, p):
    """At tp 2: a stream whose client disconnects after 3 tokens, one
    whose deadline passes mid-stream (slowed ticks); an idle gap of
    several heartbeats; then a hang on rank 0's tick thread: its stream
    errors (no other replica), the supervisor resets the engine on every
    rank through the sequencer, and the next request is served by the
    reset engine."""
    import asyncio
    import os
    from paddle_tpu_torch.serving import Gateway
    from paddle_tpu_torch.utils import faults
    from test_torch_gateway_gpu import poll, sse
    os.environ[faults.DISPATCH_HANG_ENV_VAR] = "1.5"
    gw = Gateway(seq, name="tp-faults", watchdog_timeout_s=0.5,
                 breaker_backoff_s=0.05)
    await gw.start()
    res = {}
    try:
        st, _, toks, _ = await sse(gw.port, dict(p["long"], request_id="c"),
                                   break_after=3)
        res["disconnect"] = (st, len(toks))
        res["freed"] = await poll(
            lambda: not any(seq.slots) and not seq.queue, 20)
        with faults.scoped("slow_replica"):
            st, _, toks, fin = await sse(gw.port, dict(
                p["long"], request_id="e", timeout_s=0.6))
        res["deadline"] = (st, len(toks), fin)
        await asyncio.sleep(1.0)            # five idle intervals
        res["idle_heartbeats"] = seq.sequencer_stats()["heartbeats"]
        w = gw._workers[0]
        w.inject_fault("hang")
        st, _, toks, fin = await sse(gw.port, dict(p["long"],
                                                   request_id="h"))
        res["hang"] = (st, fin)
        res["rebuilt"] = await poll(lambda: gw._workers[0] is not w
                                    and gw._workers[0].is_alive(), 30)
        res["late"] = None
        for _ in range(200):
            st, _, toks, fin = await sse(gw.port, p["late"])
            if st == 200:
                res["late"] = (st, toks, fin)
                break
            await asyncio.sleep(0.05)
    finally:
        await gw.drain()
    return res


async def _gw_spill(seq, p):
    """A is served and parks its prefix; X, Y, then Z, W fill the
    11-block pool, evicting it into each rank's arena; A again restores
    it there. Then
    a drain that migrates a live stream: the gateway cancels it on every
    rank and ends it with its committed tokens."""
    import asyncio
    from paddle_tpu_torch.serving import Gateway, KVSpillArena
    from paddle_tpu_torch.utils import faults
    from test_torch_gateway_gpu import poll, sse
    gw = Gateway(seq, name="tp-spill",
                 spill_arena=KVSpillArena(1 << 22, name="tp-spill"))
    await gw.start()
    got = {}
    try:
        for batch in p["spill_reqs"]:
            res = await asyncio.gather(*[sse(gw.port, r) for r in batch])
            for r, (st, _, toks, fin) in zip(batch, res):
                got[r["request_id"]] = (st, toks, fin)
        with faults.scoped("slow_replica"):
            task = asyncio.ensure_future(sse(gw.port, dict(
                p["long"], request_id="m")))
            await poll(lambda: any(s is not None and len(s.tokens) >= 3
                                   for s in seq.slots), 20)
            await gw.drain(migrate=True)
            st, _, toks, fin = await task
        got["m"] = (st, toks, fin)
    finally:
        await gw.drain()
    return got


CASES.update(tp_gateway=tp_gateway_cases)


def tp_fleet_reference(rank, world, p):
    """The direct tp engine a fleet failover is held to: ``replica_main
    --model tiny --tp 2``'s model from the seed and geometry, every
    request uninterrupted, and each one resumed from each prefix of its
    stream (the fleet's rule: a failed-over stream is the direct engine's
    resume of its committed prefix; a sampled one, from the empty prefix
    on, under the seed the frontend re-derives for its first hop)."""
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving.fleet import replica_main as rm
    from paddle_tpu_torch.serving.fleet.frontend import _SEED_FOLD
    env.init_parallel_env({"tp": world}, device="cpu")
    model = rm.build_sharded_model("tiny", p["seed"])
    eng = PagedEngine(model, **rm.tiny_engine_kw(p["chunk"]))
    reqs = p["reqs"]
    ref = _direct_streams(eng, [[(r["request_id"], r["prompt"],
                                  _engine_kw(r)) for r in reqs]])
    resumes = []
    for r in reqs:
        toks, lps = ref[r["request_id"]]
        sampled = {}
        if r.get("temperature"):
            sampled = dict(_engine_kw(r), seed=r["seed"] + _SEED_FOLD)
        for c in range(0 if sampled else 1, len(toks)):
            kw = dict(sampled, max_new_tokens=len(toks) - c)
            if c:
                kw.update(resume_tokens=toks[:c], resume_lps=lps[:c])
            resumes.append((f"{r['request_id']}@{c}",
                            r["prompt"] + toks[:c], kw))
    return {"ref": ref, "resumed": _direct_streams(eng, [resumes])}


CASES.update(tp_fleet_reference=tp_fleet_reference)


# ----------------------------------------------------- per-rank loading
def _layer_shapes(cfg):
    """The whole shapes of a Llama decoder layer's projections (the
    loading test's config is chosen so that no shard of one, and no other
    tensor it makes, has one of these shapes)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    d = h // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * d
    return {(h, h), (kv, h), (i, h), (h, i)}


def _whole_counter(shapes):
    """A dispatch mode that records every tensor made with one of
    ``shapes``: how many distinct ones were made (``made``), the most
    alive at once (``peak``), and marks the caller can drop between
    phases (``marks``: made so far at each mark)."""
    import weakref

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live, self.made, self.peak, self.marks = {}, 0, 0, []

        def mark(self):
            self.marks.append(self.made)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                # plain tensors: a DTensor's storage is its local one's
                if type(t) is torch.Tensor and tuple(t.shape) in shapes:
                    key = t.untyped_storage().data_ptr()
                    if key not in self.live:
                        self.made += 1
                    self.live[key] = weakref.ref(t)
            self.live = {k: r for k, r in self.live.items()
                         if r() is not None}
            self.peak = max(self.peak, len(self.live))
            return out
    return Count()


def tp_load_cases(rank, world, p):
    """``from_pretrained`` and ``load_jax_state_dict`` on {"tp": world}:
    each rank's tensors against ``shard_layer`` of the whole load, what
    the per-rank load makes and reads of a decoder layer's whole shape,
    greedy tokens, the buffers of a quantized model, the errors."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models import hf_interop
    from paddle_tpu_torch.parallel import sharding
    from paddle_tpu_torch.parallel.sharding import sharded_build
    env.init_parallel_env({"tp": world}, device="cpu")
    cfg = ptt.llama_tiny(**p["cfg"])
    shapes = _layer_shapes(cfg)
    out = {}
    whole = _serve(hf_interop.from_pretrained(p["dir"], device="cpu"))
    reads = []
    real_read = convert._read_part

    def read(src, idx):
        part = real_read(src, idx)
        reads.append(tuple(part.shape))
        return part
    convert._read_part = read
    real_layer = sharding.shard_layer
    count = _whole_counter(shapes)

    def marked(*a, **kw):
        count.mark()            # the build is over: loading begins
        return real_layer(*a, **kw)
    sharding.shard_layer = marked
    with count, sharded_build(fsdp_min_size=1 << 30):
        built = hf_interop.from_pretrained(
            p["dir"], device="cpu", generator=ptt.make_generator(3, "cpu"))
    sharding.shard_layer = real_layer
    out["count"] = (count.made, count.peak, count.marks)
    out["reads"] = list(reads)
    sharding.bind_static(built)
    out["hf_same"] = _same_locals(whole, built)
    ids = torch.from_numpy(np.asarray(p["ids"]))
    out["hf_greedy"] = ptt.generate(built, ids, max_new_tokens=8).numpy()
    # the BF16 checkpoint through the same memory-mapped reads
    bf = hf_interop.from_pretrained(p["bf16_dir"], device="cpu")
    _serve(bf)
    with sharded_build(fsdp_min_size=1 << 30):
        bf_built = hf_interop.from_pretrained(p["bf16_dir"], device="cpu")
    out["bf16_same"] = _same_locals(bf, bf_built)
    # load_jax_state_dict into a model built sharded
    jax_whole = _serve(_tp_model(p["cfg"], p["params"]))
    reads.clear()
    count = _whole_counter(shapes)
    with count:
        with sharded_build(fsdp_min_size=1 << 30):
            m = ptt.LlamaForCausalLM(cfg, device="cpu",
                                     generator=ptt.make_generator(5, "cpu"))
        sharding.shard_layer(m, fsdp_min_size=1 << 30)
        count.mark()
        convert.load_jax_state_dict(m, p["params"])
    out["jax_count"] = (count.made, count.peak, count.marks)
    out["jax_reads"] = list(reads)
    out["jax_same"] = _same_locals(jax_whole, m)
    convert._read_part = real_read
    # a quantized model's cut buffers: the state of a whole quantized
    # model loaded into another, sharded, is that model sharded
    if world == 2:
        from paddle_tpu_torch.quant import quantize_model
        qa = _tp_model(p["qcfg"], p["qparams"])
        quantize_model(qa, bits=8, skip=["lm_head", "embed"])
        qstate = {k: (v.float() if v.is_floating_point() else v).numpy()
                  for k, v in convert.jax_state_dict(qa).items()}
        sharding.shard_layer(qa, fsdp_min_size=1 << 30)
        qb = ptt.LlamaForCausalLM(ptt.llama_tiny(**p["qcfg"]), device="cpu",
                                  generator=ptt.make_generator(9, "cpu"))
        quantize_model(qb, bits=8, skip=["lm_head", "embed"])
        sharding.shard_layer(qb, fsdp_min_size=1 << 30)
        convert.load_jax_state_dict(qb, qstate)
        out["quant_same"] = _same_locals(qa, qb)
    # an MoE checkpoint: the router, shared experts and experts (E / ep a
    # rank, here ep 1) loaded a rank's slices at a time (heads 4 / 2: tp 2)
    if world == 2:
        moe = _serve(hf_interop.from_pretrained(p["moe_dir"], device="cpu"))
        with sharded_build(fsdp_min_size=1 << 30):
            moe_built = hf_interop.from_pretrained(p["moe_dir"],
                                                   device="cpu")
        sharding.bind_static(moe_built)
        out["moe_same"] = _same_locals(moe, moe_built)
    # the whole loader's errors, on a mesh
    for key in ("missing", "shape"):
        try:
            with sharded_build(fsdp_min_size=1 << 30):
                hf_interop.from_pretrained(p[f"{key}_dir"], device="cpu")
            out[key] = None
        except (KeyError, ValueError) as e:
            out[key] = (type(e).__name__, str(e))
    return out


def _same_locals(a, b):
    """Every parameter and buffer of ``a`` and ``b``: this rank's local
    tensors bit for bit equal (names that differ count as unequal)."""
    import torch
    from paddle_tpu_torch.parallel.sharding import local
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(
        torch.equal(local(sa[k]), local(sb[k])) for k in sa)


CASES.update(tp_load=tp_load_cases)


# ------------------------------------------------- tp (x ep) MoE serving
# whole-prompt prefill (neither package chunk-prefills an MoE model)
MOE_GEO = dict(max_slots=2, num_blocks=24, block_size=8,
               max_blocks_per_seq=6, prefill_buckets=(16,))


def moe_model(kind, cfg):
    """(model class, config) of a tiny MoE family ``kind`` with the
    overrides ``cfg``."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import deepseek_v2 as ds
    cls, tiny = {
        "qwen": (models.Qwen2MoeForCausalLM, models.qwen2_moe_tiny),
        "dsmoe": (models.Qwen2MoeForCausalLM,
                  models.qwen2_moe.deepseek_moe_tiny),
        "ernie": (models.Ernie45MoeForCausalLM, models.ernie45_moe_tiny),
        "ds2": (ds.DeepseekV2ForCausalLM, ds.deepseek_v2_tiny),
        "ds3": (ds.DeepseekV2ForCausalLM, ds.deepseek_v2_tiny),
        "qwenq": (models.Qwen2MoeForCausalLM, models.qwen2_moe_tiny)}[kind]
    return cls, tiny(**cfg)


def _moe_served(kind, p):
    """The JAX weights of ``kind`` in a port model built inside
    ``sharded_build`` (each decoder layer cut to this rank's heads and
    experts as drawn), cut by ``shard_layer``, loaded a rank's slices at
    a time (``load_jax_state_dict``) and bound once; and whether its
    tensors are ``shard_layer`` of the whole model loaded whole and every
    compute tensor (tp and ep shards alike) the local shard itself."""
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.parallel.sharding import (bind_static, local,
                                                    shard_layer,
                                                    sharded_build)
    cls, cfg = moe_model(kind, p["cfgs"][kind])
    with sharded_build(fsdp_min_size=1 << 30):
        m = cls(cfg, device="cpu")
    shard_layer(m, fsdp_min_size=1 << 30)
    load_jax_state_dict(m, p["params"][kind])
    bound = bind_static(m)
    alias = all(bound[n].data_ptr() == local(t).data_ptr()
                for n, t in m.named_parameters())
    whole = _serve(_jax_weights(cls(cfg, device="cpu"), p["params"][kind]))
    return m, (_same_locals(whole, m), alias)


class _Routes:
    """Records every MoE layer's router scores and routing decisions
    ((logits, experts, slots, kept) per token) while on."""

    def __enter__(self):
        from paddle_tpu_torch.parallel import moe
        self.calls, self._real = [], moe._route

        def route(*a, **kw):
            out = self._real(*a, **kw)
            self.calls.append(tuple(t.detach().cpu().numpy().copy()
                                    for t in (a[0],) + out[:3]))
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.parallel import moe
        moe._route = self._real


def _engine_streams(model, script):
    """``script`` (batches of (request id, prompt, engine kwargs)) on a
    fresh PagedEngine at ``MOE_GEO``: tokens and logprobs by request."""
    from paddle_tpu_torch.generation.paged import PagedEngine
    return _direct_streams(PagedEngine(model, **MOE_GEO), script)


def _moe_generates(m, ids, out, tag, beam=True, sampled=False):
    import torch
    import paddle_tpu_torch as ptt
    with torch.no_grad(), _Routes() as routes:
        out[f"{tag}_logits"] = m(ids).float().numpy()
    out[f"{tag}_routes"] = routes.calls
    out[f"{tag}_greedy"] = ptt.generate(m, ids, max_new_tokens=8).numpy()
    if beam:
        out[f"{tag}_beam"] = ptt.generate(m, ids, max_new_tokens=6,
                                          num_beams=3).numpy()
    if sampled:
        out[f"{tag}_sampled"] = ptt.generate(
            m, ids, max_new_tokens=8, do_sample=True, temperature=0.8,
            top_k=20, generator=ptt.make_generator(3, "cpu")).numpy()


def _mtp(m, ids, out, tag):
    from paddle_tpu_torch.generation.speculative import \
        mtp_speculative_generate
    got, stats = mtp_speculative_generate(m, ids, max_new_tokens=8,
                                          num_draft_tokens=3,
                                          return_stats=True)
    out[f"{tag}_mtp"] = got.numpy()
    out[f"{tag}_mtp_forwards"] = stats["target_forwards"]


def _moe_checkpoints(p, out):
    """Each MoE family's HF checkpoint loaded whole then sharded, and
    inside ``sharded_build``: this rank's tensors bit for bit, and the
    shapes of the expert slices it read."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import hf_interop
    from paddle_tpu_torch.parallel.sharding import bind_static, sharded_build
    reads, experts = [], []
    real_read, real_copy = convert._read_part, hf_interop._copy_experts

    def read(src, idx):
        part = real_read(src, idx)
        reads.append(tuple(part.shape))
        return part

    def copy(name, dst, by_id):
        n = len(reads)
        real_copy(name, dst, by_id)
        experts.extend(reads[n:])
    for family, d in p["ckpts"].items():
        whole = _serve(hf_interop.from_pretrained(d, device="cpu"))
        experts.clear()
        convert._read_part, hf_interop._copy_experts = read, copy
        try:
            with sharded_build(fsdp_min_size=1 << 30):
                built = hf_interop.from_pretrained(d, device="cpu")
        finally:
            convert._read_part, hf_interop._copy_experts = \
                real_read, real_copy
        bind_static(built)
        out[f"ckpt_{family}"] = (_same_locals(whole, built), list(experts))


def tp_moe_cases(rank, world, p):
    """The MoE families and MLA served on ``p["mesh"]`` (tp, or tp x ep):
    every model built sharded and loaded from the JAX weights a rank's
    slices at a time; prefill logits and routing decisions, greedy, beam
    and sampled ``generate()``, the PagedEngine, ``Predictor`` int8 and
    bf16, MTP-as-draft, HF checkpoints loaded inside ``sharded_build``,
    and at tp x ep a SequencedEngine behind the port's ``Gateway``."""
    import asyncio

    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(p["mesh"], device="cpu")
    out = {}
    ids = torch.from_numpy(np.asarray(p["ids"]))
    for kind in p["models"]:
        m, out[f"{kind}_same"] = _moe_served(kind, p)
        mlp = next(l for l in m.model.layers if not l.is_dense).mlp
        out[f"{kind}_experts"] = tuple(mlp.w_gate.shape)
        out[f"{kind}_cache"] = tuple(m.init_kv_caches(1, 4)[0][0].shape)
        _moe_generates(m, ids, out, kind, beam=kind in p["beam"],
                       sampled=kind in p["sampled"])
        if kind == "ds3":
            _mtp(m, ids, out, kind)
        if kind in p["engine"]:
            out[f"{kind}_engine"] = _engine_streams(m, p["script"])
        if kind == p.get("gateway"):
            out["gateway"] = _sequenced_world(
                m, MOE_GEO, lambda seq: asyncio.run(
                    _gw_parity(seq, p["gw_reqs"])), idle_interval_s=0.2)
            out["gateway_direct"] = _engine_streams(m, [
                [(r["request_id"], r["prompt"], _engine_kw(r))
                 for r in batch] for batch in p["gw_reqs"]])
        if kind in p["int8"]:
            q, _ = _moe_served(kind, p)
            pred = ptt.Predictor(q, ptt.Config().enable_weight_only_quant(8),
                                 device="cpu")
            attn = q.model.layers[0].self_attn
            out[f"{kind}_int8_codes"] = (tuple(attn.q_proj.qweight.shape),
                                         tuple(attn.o_proj.qweight.shape))
            out[f"{kind}_int8_logits"] = pred.run(ids).numpy()
            out[f"{kind}_int8_greedy"] = pred.generate(
                ids, max_new_tokens=6).numpy()
        if kind in p["bf16"]:
            b, _ = _moe_served(kind, p)
            pred = ptt.Predictor(b, ptt.Config().set_dtype("bfloat16"),
                                 device="cpu")
            out[f"{kind}_bf16_logits"] = pred.run(ids).float().numpy()
            out[f"{kind}_bf16_greedy"] = pred.generate(
                ids, max_new_tokens=8).numpy()
    for kind in p["int4"]:
        q, _ = _moe_served(kind, p)
        pred = ptt.Predictor(q, ptt.Config().enable_weight_only_quant(4),
                             device="cpu")
        attn = q.model.layers[0].self_attn
        out[f"{kind}_int4_codes"] = (tuple(attn.q_proj.qweight.shape),
                                     tuple(attn.o_proj.qweight.shape))
        out[f"{kind}_int4_logits"] = pred.run(ids).numpy()
        out[f"{kind}_int4_greedy"] = pred.generate(
            ids, max_new_tokens=6).numpy()
    if p.get("ckpts"):
        _moe_checkpoints(p, out)
    return out


CASES.update(tp_moe=tp_moe_cases)


# ------------------------------------------------------------ LoRA at tp
def lora_tp_cases(rank, world, p):
    """LoRA on {"tp": world}: the tiny Llama with adapters on every
    projection, the JAX weights (adapters included) loaded, sharded by
    ``fleet.distributed_model``; each adapter's split (per dim, "tp" or
    None) and local shape, then one SFTTrainer step on the packed batch
    and the gathered adapters after it."""
    import torch
    from torch.distributed.tensor import Shard
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.peft import LoRAConfig, apply_lora, lora_state_dict
    from paddle_tpu_torch.trl import SFTTrainer
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={"mp_degree": world}), device="cpu")
    model = _tiny_llama(0)
    apply_lora(model, LoRAConfig(**p["lora"]))
    _jax_weights(model, p["params"])
    fleet.distributed_model(model)
    out = {"spec": {}, "local": {}}
    for name, t in lora_state_dict(model).items():
        out["spec"][name] = tuple(
            "tp" if any(isinstance(pl, Shard) and pl.dim == d
                        for pl in t.placements) else None
            for d in range(t.dim()))
        out["local"][name] = tuple(t.to_local().shape)
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    args = ptt.TrainingArguments(output_dir=os.path.join(p["out_dir"],
                                                         str(rank)),
                                 max_steps=1, logging_steps=1,
                                 prefetch_depth=0)
    tr = SFTTrainer(model, ptt.optimizer.AdamW(learning_rate=1e-3), args,
                    train_dataloader=[batch])
    tr.train()
    out["loss"] = _losses(tr)
    out["adapters"] = {k: _np(v) for k, v in lora_state_dict(model).items()}
    return out


CASES.update(lora_tp=lora_tp_cases)


# ------------------------------------------------------------ vision at dp 2
def clip_dp_cases(rank, world, p):
    """CLIP's contrastive loss over {"dp": 2, "tp": 2} (each tower's fused
    qkv split over tp): this rank's half of the batch (by its dp
    coordinate) against the gathered features; the loss and the
    gradients of the projections and logit scale. Then ``SyncBatchNorm``
    in training on this rank's rows: the output and the running
    statistics (the global batch's)."""
    import math

    import torch
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models import (CLIPModel, clip_contrastive_loss,
                                         clip_tiny, gather_features)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.parallel.sharding import materialize, shard_layer
    D.init_parallel_env(p["mesh"], device="cpu")
    dp, coord = env.axis_degree("dp"), env.axis_coordinate("dp")
    model = _jax_weights(CLIPModel(clip_tiny(), device="cpu"), p["params"])
    shard_layer(model)
    # the towers are called outside the model's forward (its pre-hook):
    # bind the compute tensors (tp shards kept, the rest replicated)
    materialize(model)
    ids = torch.from_numpy(p["ids"]).long().chunk(dp)[coord]
    px = torch.from_numpy(p["px"]).chunk(dp)[coord]
    t = F.normalize(model.encode_text(ids), axis=-1)
    v = F.normalize(model.encode_image(px), axis=-1)
    scale = torch.exp(torch.clamp(model.logit_scale, max=math.log(100.0)))
    tg, vg = gather_features(t, "dp"), gather_features(v, "dp")
    loss = clip_contrastive_loss(scale * v @ tg.T, scale * t @ vg.T,
                                 dp_axis="dp")
    names = ("logit_scale", "text_projection", "visual_projection")
    grads = torch.autograd.grad(loss, [getattr(model, k) for k in names])
    out = {"loss": float(loss), "grads": dict(zip(names, _np(list(grads)))),
           "dp": coord, "tp": env.axis_coordinate("tp")}
    bn = nn.SyncBatchNorm(3, device="cpu")
    y = bn(torch.from_numpy(p["bn_x"]).chunk(dp)[coord])
    out["bn"] = dict(y=_np(y), mean=_np(bn._mean), var=_np(bn._variance))
    env.clear_mesh()
    return out


CASES.update(clip_dp=clip_dp_cases)


# ------------------------------------------------------ BatchNorm at dp 2
def _bn_family(name, params):
    from paddle_tpu_torch.models import (DBNet, ResNet, dbnet_tiny,
                                         resnet_tiny)
    model = (ResNet(resnet_tiny(), device="cpu") if name == "resnet"
             else DBNet(dbnet_tiny(), device="cpu"))
    return _jax_weights(model, params)


def _bn_loss(name):
    from paddle_tpu_torch.models import db_loss
    from paddle_tpu_torch.nn import functional as F
    if name == "resnet":
        return lambda m, b: F.cross_entropy(m(b["x"]), b["labels"])
    return lambda m, b: db_loss(m(b["x"]), b["shrink"], b["mask"],
                                b["thresh"], b["tmask"])


def bn_dp_cases(rank, world, p):
    """BatchNorm over {"dp": world}: for ResNet and DBNet, an eager
    train-mode forward on this rank's rows (the running statistics it
    leaves), then ``Trainer(loss_fn=...)``, SGD, 3 steps on the global
    batch (losses, every parameter, the buffers); ``SyncBatchNorm``'s
    output and gradients on this rank's rows; the collectives counted."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import SyncBatchNorm, norm
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={"dp_degree": world}), device="cpu")
    out = {}
    for name in ("resnet", "dbnet"):
        batch = {k: torch.from_numpy(v) for k, v in p[name]["batch"].items()}
        model = _bn_family(name, p[name]["params"]).train()
        with torch.no_grad():
            model(batch["x"].chunk(world)[rank])
        out[f"{name}_eager"] = {k: _np(v) for k, v in model.state_dict()
                                .items() if k.endswith(("_mean",
                                                        "_variance"))}
        model = _bn_family(name, p[name]["params"])
        fleet.distributed_model(model)
        before = norm.stat_reductions
        tr = ptt.Trainer(model, ptt.optimizer.SGD(learning_rate=p["lr"][name]),
                         ptt.TrainingArguments(
                             output_dir=os.path.join(p["out"], name, str(rank)),
                             max_steps=3, logging_steps=1, prefetch_depth=0,
                             graceful_shutdown=False),
                         loss_fn=_bn_loss(name), train_dataloader=[batch])
        tr.train()
        out[f"{name}_reductions"] = norm.stat_reductions - before
        out[f"{name}_losses"] = [v for _, v in _losses(tr)]
        out[f"{name}_state"] = {k: _np(v)
                                for k, v in model.state_dict().items()}
    bn = SyncBatchNorm(3, device="cpu")
    x = torch.from_numpy(p["sync"]["x"]).chunk(world)[rank].requires_grad_()
    w = torch.from_numpy(p["sync"]["w"]).chunk(world)[rank]
    y = bn(x)
    gx, gw, gb = torch.autograd.grad((y * w).sum(), [x, bn.weight, bn.bias])
    out["sync"] = dict(y=_np(y), gx=_np(gx), gw=_np(gw), gb=_np(gb),
                       mean=_np(bn._mean), var=_np(bn._variance))
    return out


CASES.update(bn_dp=bn_dp_cases)


# ------------------------------------------ the fused-qkv families on tp
def _zoo_model(name, cfg_kw):
    """A port model of the tiny family ``name`` (the families of
    ``test_torch_tp_zoo.py``), on the CPU."""
    from paddle_tpu_torch import models as M
    cls, cfg = {
        "gpt": (M.GPTForCausalLM, M.gpt_tiny),
        "bert-pt": (M.BertForPretraining, M.bert_tiny),
        "bert-cls": (M.BertForSequenceClassification, M.bert_tiny),
        "ernie-mlm": (M.ErnieForMaskedLM, M.ernie_tiny),
        "ernie-cls": (M.ErnieForSequenceClassification, M.ernie_tiny),
        "vit": (M.ViTForImageClassification, M.vit_tiny),
        "clip": (M.CLIPModel, M.clip_tiny),
        "dit": (M.DiT, M.dit_tiny),
        "mmdit": (M.MMDiT, M.mmdit_tiny),
    }[name]
    return cls(cfg(**cfg_kw), device="cpu")


def zoo_loss(name):
    """The port's ``loss_fn(model, batch)`` of a family's Trainer case."""
    import torch
    from paddle_tpu_torch.models import (clip_contrastive_loss,
                                         pretraining_loss)
    from paddle_tpu_torch.nn import functional as F

    def enc(m, b):
        return m(torch.as_tensor(b["ids"]), torch.as_tensor(b["types"]),
                 torch.as_tensor(b["mask"]))
    if name == "bert-pt":
        def loss(m, b):
            mlm, nsp = enc(m, b)
            return pretraining_loss(mlm, b["mlm_labels"], nsp, b["labels"])
        return loss
    if name == "ernie-mlm":
        return lambda m, b: F.cross_entropy(enc(m, b), b["mlm_labels"],
                                            ignore_index=-100)
    if name in ("bert-cls", "ernie-cls"):
        return lambda m, b: F.cross_entropy(enc(m, b), b["labels"])
    if name == "vit":
        return lambda m, b: F.cross_entropy(m(b["px"]), b["labels"])
    if name == "clip":
        return lambda m, b: clip_contrastive_loss(*m(b["ids"], b["px"]))
    return None                                  # gpt: the causal-LM loss


def _zoo_sharded(name, p, build=False):
    """Family ``name`` on the installed mesh holding the JAX weights:
    built inside ``sharded_build`` and loaded a rank's slices at a time
    (``build``), or loaded whole and then sharded."""
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.parallel.sharding import shard_layer, sharded_build
    fam = p["families"][name]
    if build:
        with sharded_build():
            m = _zoo_model(name, fam["cfg"])
        shard_layer(m)
        load_jax_state_dict(m, fam["params"])
        return m
    m = _jax_weights(_zoo_model(name, fam["cfg"]), fam["params"])
    shard_layer(m)
    return m


def _zoo_train(name, p, out_dir):
    import torch
    import paddle_tpu_torch as ptt
    fam = p["families"][name]
    m = _zoo_sharded(name, p)
    batch = fam["batch"]
    data = ([torch.from_numpy(b).long() for b in batch] if name == "gpt"
            else [{k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                   else torch.from_numpy(v) for k, v in batch.items()}])
    tr = ptt.Trainer(m, ptt.optimizer.SGD(learning_rate=fam["lr"]),
                     ptt.TrainingArguments(output_dir=out_dir, max_steps=3,
                                           logging_steps=1, prefetch_depth=0,
                                           graceful_shutdown=False),
                     loss_fn=zoo_loss(name), train_dataloader=data)
    tr.train()
    return {"losses": [v for _, v in _losses(tr)],
            "state": {k: _np(v) for k, v in m.state_dict().items()}}


def tp_zoo_cases(rank, world, p):
    """The GPT, BERT/ERNIE, ViT, CLIP, DiT and MMDiT families on
    ``p["mesh"]`` ({"tp": 2}, or {"dp": 2, "tp": 2} for ``p["train"]``
    alone): GPT built in ``sharded_build`` (each rank's q, k, v columns
    read from the JAX state dict), its state dict back in the JAX layout;
    logits, greedy and beam ``generate()``, the weight-only ``Predictor``
    at int8 and int4; the Trainer cases; the encoders' eval outputs; a
    DiT and an MMDiT step and a DiT pipeline; dropout on a tp mesh."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel.sharding import bind_static, local
    env.init_parallel_env(p["mesh"], device="cpu")
    out = {}
    for name in p["train"]:
        out[f"train_{name}"] = _zoo_train(
            name, p, os.path.join(p["out"], name, str(rank)))
    gpt_ids = torch.from_numpy(p["gpt_ids"]).long()
    g = _zoo_sharded("gpt", p, build=True)
    qkv = g.model.layers[0].attn.qkv_proj
    out["gpt_qkv_local"] = (local(qkv._parameters["weight"]).numpy().copy(),
                            local(qkv._parameters["bias"]).numpy().copy())
    out["gpt_state"] = {k: _np(v) for k, v in g.state_dict().items()}
    bind_static(g)
    with torch.no_grad():
        out["gpt_logits"] = g(gpt_ids).numpy()
    if not p["serve"]:
        return out
    out["gpt_greedy"] = ptt.generate(g, gpt_ids, max_new_tokens=8).numpy()
    out["gpt_beam"] = ptt.generate(g, gpt_ids, max_new_tokens=6,
                                   num_beams=3).numpy()
    for bits in (8, 4):
        m = _zoo_sharded("gpt", p)
        bind_static(m)
        pred = ptt.Predictor(m, ptt.Config().enable_weight_only_quant(bits),
                             device="cpu")
        out[f"gpt_q{bits}_logits"] = pred.run(gpt_ids).numpy()
        out[f"gpt_q{bits}_greedy"] = pred.generate(gpt_ids,
                                                   max_new_tokens=6).numpy()
    for name in ("vit", "clip", "dit", "mmdit"):
        m = _zoo_sharded(name, p).eval()
        bind_static(m)
        args = [torch.from_numpy(a) if a.dtype.kind == "f"
                else torch.from_numpy(a).long() for a in p[f"{name}_in"]]
        with torch.no_grad():
            y = m(*args)
        out[f"{name}_out"] = _np(list(y) if isinstance(y, tuple) else y)
        if name == "dit":
            from paddle_tpu_torch.diffusion.pipelines import DiTPipeline
            out["dit_pipe"] = DiTPipeline(m)(
                p["pipe_labels"], num_inference_steps=4,
                generator=torch.Generator().manual_seed(p["pipe_seed"])
            ).numpy()
    out.update(_tp_dropout(p))
    return out


def _tp_dropout(p):
    """A train-mode BERT forward with dropout on a tp mesh: the hidden
    states (replicated after each row-parallel reduce, one dropout mask
    on every rank), and a dropout over this rank's attention
    probabilities (its heads: its own bits, ``utils.rng.fold_axis``)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import BertModel, bert_tiny
    from paddle_tpu_torch.ops.attention import dense_attention
    from paddle_tpu_torch.parallel.sharding import bind_static, shard_layer
    from paddle_tpu_torch.utils.rng import fold_axis
    cfg = bert_tiny(hidden_dropout_prob=0.1)
    m = BertModel(cfg, device="cpu", generator=ptt.make_generator(5, "cpu"))
    shard_layer(m)
    bind_static(m)
    m.train()
    ids = torch.from_numpy(p["drop_ids"]).long()
    with torch.no_grad():
        hidden, _ = m(ids)
        x = m.embeddings(ids)
        b, s, _ = x.shape
        q, k, _ = m.layers[0].attention.qkv_proj(x).reshape(
            b, s, 3, -1, cfg.head_dim).unbind(2)
        # values that pick each key: the output is the dropped
        # probability matrix itself, zero exactly where the mask drops
        pick = torch.eye(s)[None, :, None, :].expand(b, s, q.shape[2], s)
        gen = fold_axis(ptt.make_generator(9, "cpu"), "tp")
        dropped = dense_attention(q, k, pick, dropout_p=0.1, generator=gen)
    return {"drop_hidden": hidden.numpy(),
            "drop_mask": (dropped != 0).numpy()}


CASES.update(tp_zoo=tp_zoo_cases)


# ------------------------------------------------- per-rank checkpoints
class _NewBytes:
    """A dispatch mode summing the bytes of every plain tensor an op makes
    on storage of its own, not its inputs' (what a save allocates; a
    DTensor's ops are counted through its local tensors')."""

    def __init__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        outer = self
        self.total = 0

        def ptrs(xs):
            return {t.untyped_storage().data_ptr() for t in xs
                    if type(t) is torch.Tensor}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                seen = ptrs(tree_leaves((args, kwargs)))
                for t in tree_leaves(out):
                    if type(t) is torch.Tensor and \
                            t.untyped_storage().data_ptr() not in seen:
                        outer.total += t.untyped_storage().nbytes()
                return out
        self.mode = Mode()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif hasattr(tree, "shape"):
        yield prefix[:-1], tree


def _restores_bit_for_bit(ckpt, step, tr, saved):
    """Restore ``step`` into a tree like ``tr``'s state (this rank's
    shards read alone) and compare each leaf with this rank's shard of
    the saved full tensor, bit for bit."""
    import torch
    from paddle_tpu_torch.parallel.sharding import local, local_shard
    tr._opt_state = tr.optimizer.init(tr._trainable)
    like = tr._state_tree()
    got = ckpt.restore(step, like=like)
    same = {}
    mine = dict(_leaves(got))
    for name, live in _leaves(like):
        want = local_shard(torch.from_numpy(saved[name]).to(live.dtype), live)
        same[name] = (tuple(mine[name].shape) == tuple(local(live).shape)
                      and torch.equal(mine[name], want))
    return same


def ckpt_ranks_cases(rank, world, p):
    """Per-rank checkpoints on a world of 2: the Trainer on {"fsdp": 2}
    saves step 2 (each rank its own shards; the bytes a save allocates
    counted), resumes it to step 4; step 2 restored into {"fsdp": 2} and
    {"tp": 2} (each rank reading its shards alone) bit for bit."""
    from paddle_tpu_torch.checkpoint.distributed_ckpt import \
        DistributedCheckpoint
    from paddle_tpu_torch.distributed import env
    shared = p["dir"]
    out = {}
    tr, model = _train({"fsdp": 2}, p, shared, steps=2, save_steps=2)
    tr._ckpt.wait_until_finished()
    out["saved"] = {k: _np(v) for k, v in _leaves(tr._state_tree())}
    counter = _NewBytes()
    with counter.mode:
        tr.save_checkpoint(wait=True)
    out["save_new_bytes"] = counter.total
    out["save_bytes"] = tr._ckpt.last_save["bytes"]
    out["total_bytes"] = sum(v.nbytes for v in out["saved"].values())
    env.clear_mesh()
    tr2, _ = _train({"fsdp": 2}, p, shared, steps=4, save_steps=2)
    out["resumed"] = _losses(tr2)
    env.clear_mesh()
    ckpt = DistributedCheckpoint(os.path.join(shared, "checkpoints"))
    for key, shape in (("fsdp", {"fsdp": 2}), ("tp", {"tp": 2})):
        from paddle_tpu_torch.distributed import fleet
        inv = {v: k for k, v in
               fleet.DistributedStrategy._DEGREE_TO_AXIS.items()}
        fleet.init(strategy=fleet.DistributedStrategy(
            hybrid_configs={inv[a]: n for a, n in shape.items()},
            sharding_stage=3), device="cpu")
        model = _tiny_llama(0, **p.get("cfg", {}))
        fleet.distributed_model(model, fsdp_min_size=p["fsdp_min_size"])
        tr3 = _trainer(model, [], os.path.join(p["scratch"], key,
                                               str(rank)), 0)
        out[f"restore_{key}"] = _restores_bit_for_bit(ckpt, 2, tr3,
                                                      out["saved"])
        env.clear_mesh()
    return out


CASES.update(ckpt_ranks=ckpt_ranks_cases)


# ------------------------------------------- a tp replica's KV transfer
def longest_resident(eng, arena, ids):
    """The hex digest of the longest chunk-grid span of ``ids`` held in
    ``arena`` (the gateway's own walk), or None."""
    for raw in reversed(eng._chunk_digests(list(ids), len(ids) - 1)):
        if arena.probe(raw) is not None:
            return raw.hex()
    return None


def kvx_resume(q, done, k, record):
    """A resumed stream's request: prompt ``q`` plus the first ``k`` of
    its ``done`` tokens committed, the span as an inline record."""
    import base64
    return dict(request_id=f"resume-{len(q)}-{k}", prompt=list(q) + done[:k],
                resume_tokens=done[:k], max_new_tokens=len(done) - k,
                temperature=0.0,
                resume_kv="b64:" + base64.b64encode(record).decode())


def tp_kvxfer_cases(rank, world, p):
    """A sequenced replica on ``p["mesh"]`` ({"tp": 2}, or {"tp": 2,
    "ep": 2} with the dense model: each ep rank holds the same heads)
    behind the port's ``Gateway``: a stream migrated from a tp 1 replica
    resumes from its imported record; a span it served comes out of
    ``/kvz``; a corrupt and a truncated record re-prefill."""
    import asyncio
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.serving import KVSpillArena
    env.init_parallel_env(p["mesh"], device="cpu")
    model = _serve(_tp_model(p["cfg"], p["params"]))
    return _sequenced_world(
        model, TP_GEO, lambda seq: asyncio.run(_kvx_leader(seq, p)),
        idle_interval_s=0.2, spill_arena=KVSpillArena(1 << 22))


async def _kvx_leader(seq, p):
    from paddle_tpu_torch.serving import Gateway, KVSpillArena, kvxfer
    from test_torch_gateway_gpu import http, sse
    gw = Gateway(seq, name=f"tp-kvx-{seq.tp}",
                 spill_arena=KVSpillArena(1 << 22, name=f"tp-kvx-{seq.tp}"))
    await gw.start()
    out = {}
    try:
        q1, u1 = p["streams"]["q1"]
        st, _, toks, fin = await sse(gw.port, kvx_resume(q1, u1, 3,
                                                         p["r1"]))
        out["resume"] = (st, toks, fin["finish_reason"])
        out["after_resume"] = (kvxfer.counters_snapshot(gw.name),
                               dict(seq.stats))
        q2, _ = p["streams"]["q2"]
        st, _, toks, fin = await sse(gw.port, dict(
            request_id="q2", prompt=q2, max_new_tokens=p["new"],
            temperature=0.0))
        out["q2"] = (st, toks)
        seq.spill_parked()
        digest = longest_resident(seq, gw._spill_arena, q2 + toks[:3])
        st, _, blob = await http(gw.port, "GET", f"/kvz?digest={digest}")
        out["kvz"] = (st, digest, blob)
        q3, u3 = p["streams"]["q3"]
        for kind in ("corrupt", "trunc"):
            st, _, toks, fin = await sse(gw.port, dict(
                kvx_resume(q3, u3, 3, p[f"r3_{kind}"]),
                request_id=f"q3-{kind}"))
            out[kind] = (st, toks)
        out["end"] = (kvxfer.counters_snapshot(gw.name), dict(seq.stats))
    finally:
        await gw.drain()
    return out


CASES.update(tp_kvxfer=tp_kvxfer_cases)
