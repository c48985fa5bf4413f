"""The port's report tools (``python -m paddle_tpu_torch.tools.<name>``)
against the repo's ``tools/<name>.py`` on dumps the port writes with its
own classes: a gateway run dir (its ``PagedEngine(tick_profile=True)``
on the tick stub, streamed requests, ``Gateway.dump_traces`` /
``dump_tick_profiles`` and ``observability.reset()``'s flush: the
reqtrace ring, the tick-phase docs, the series doc, the Chrome trace)
and a ``Trainer`` run dir. Each tool runs as a subprocess, both sides
on the same files: ``trace_report --json``, ``obs_report --json`` and
``fleet_dash``'s render must be equal byte for byte, ``trace_export``'s
Chrome trace equal and ``--check``-clean, and ``obs_report --check``
(the port's writers against its reader) must exit 0."""
import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.generation.stub import TickStubModel
from paddle_tpu_torch.serving import Gateway
from paddle_tpu_torch.utils import observability as obs
from test_torch_gateway_gpu import sse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _gateway_dir(path):
    obs.reset()
    obs.configure(path)

    async def run():
        eng = PagedEngine(TickStubModel(), max_slots=4, num_blocks=64,
                          block_size=8, max_blocks_per_seq=8,
                          prefill_buckets=(16,), chunk_prefill_tokens=8,
                          enable_prefix_cache=True, tick_profile=True)
        gw = Gateway(eng, name="tools")
        await gw.start()
        try:
            res = await asyncio.gather(*[
                sse(gw.port, dict(prompt=list(range(1, 5 + 3 * i)),
                                  max_new_tokens=8 + i))
                for i in range(4)])
            assert [r[0] for r in res] == [200] * 4
            assert gw.dump_traces(path) and gw.dump_tick_profiles(path)
        finally:
            await gw.drain()

    try:
        asyncio.run(run())
    finally:
        obs.reset()          # flushes the series doc and the trace


def _trainer_dir(path):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        torch.manual_seed(0)
        tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
        rs = np.random.RandomState(0)
        batches = [rs.randint(0, 256, (2, 16)).astype(np.int32)
                   for _ in range(3)]
        args = ptt.TrainingArguments(output_dir=path, max_steps=3,
                                     logging_steps=1,
                                     graceful_shutdown=False)
        ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=1e-3), args,
                    train_dataloader=batches).train()
    finally:
        torch.set_num_threads(prev)
        obs.reset()
    return os.path.join(path, "runs")


CASES = (
    ("trace_report", "gw", ("--json",)),
    ("obs_report", "gw", ("--json",)),
    ("obs_report", "train", ("--json",)),
    ("obs_report", "train", ()),
    ("fleet_dash", "gw", ()),
    ("trace_report", "gw", ()),
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every tool run, both sides, started at once: {key: (rc, out)}."""
    base = tmp_path_factory.mktemp("dumps")
    dirs = {"gw": str(base / "gw")}
    os.makedirs(dirs["gw"])
    _gateway_dir(dirs["gw"])
    dirs["train"] = _trainer_dir(str(base / "train"))
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               COLUMNS="100")
    cmds = {}
    for tool, where, extra in CASES:
        args = [dirs[where], *extra]
        cmds[("jax", tool, where, extra)] = [
            sys.executable, os.path.join(ROOT, "tools", f"{tool}.py"), *args]
        cmds[("port", tool, where, extra)] = [
            sys.executable, "-m", f"paddle_tpu_torch.tools.{tool}", *args]
    for side in ("jax", "port"):
        out = str(base / f"{side}_trace.json")
        cmds[(side, "trace_export")] = (
            [sys.executable, os.path.join(ROOT, "tools", "trace_export.py")]
            if side == "jax" else
            [sys.executable, "-m", "paddle_tpu_torch.tools.trace_export"]
        ) + [dirs["gw"], "-o", out, "--check"]
    cmds[("port", "obs_check")] = [
        sys.executable, "-m", "paddle_tpu_torch.tools.obs_report", "--check"]
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=str(base))
             for k, c in cmds.items()}
    done = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=TIMEOUT_S)
        done[k] = (p.returncode, out, err)
    return base, dirs, done


def test_the_port_tools_import_no_jax():
    import pathlib
    import re
    for f in (pathlib.Path(ROOT) / "paddle_tpu_torch" / "tools").glob(
            "*.py"):
        text = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|paddle_tpu)\b",
                             text, re.M), f.name


@pytest.mark.parametrize("tool,where,extra", CASES)
def test_tool_output_equals_the_jax_tool(runs, tool, where, extra):
    _, _, done = runs
    jrc, jout, jerr = done[("jax", tool, where, extra)]
    prc, pout, perr = done[("port", tool, where, extra)]
    assert jrc == 0, jerr
    assert prc == 0, perr
    assert pout.strip(), "empty summary"
    assert pout == jout


def test_trace_export_is_equal_and_passes_check(runs):
    base, _, done = runs
    for side in ("jax", "port"):
        rc, out, err = done[(side, "trace_export")]
        assert rc == 0, err
    with open(base / "jax_trace.json") as f:
        want = f.read()
    with open(base / "port_trace.json") as f:
        got = f.read()
    assert got == want and '"traceEvents"' in got


def test_obs_report_check_passes_on_the_port_writers(runs):
    _, _, done = runs
    rc, out, err = done[("port", "obs_check")]
    assert rc == 0, err
    assert "schema OK" in out


def test_gateway_dumps_are_every_kind(runs):
    _, dirs, _ = runs
    names = sorted(os.listdir(dirs["gw"]))
    for prefix in ("reqtrace_", "tickphase_", "series_", "trace_"):
        assert any(n.startswith(prefix) for n in names), (prefix, names)
    assert any(n.startswith("metrics") for n in os.listdir(dirs["train"]))
