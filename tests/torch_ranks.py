"""Run a function on every rank of a ``gloo`` process group on the CPU, each
rank a spawned process, for the port's distributed tests.

The ranks import torch, the port and the module that holds the function,
never JAX: test modules that use this keep their JAX imports inside the
parent's test functions. Each run has its own time limit (ranks joined with a
timeout, then killed) and its own ``file://`` store; the process group's own
timeout is 60 s, so a rank whose peer died stops waiting.
"""

import datetime
import importlib
import multiprocessing
import pathlib
import time
import traceback

import torch

GROUP_TIMEOUT_S = 60


def _rank_entry(rank, world, store, out_dir, module, name, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        fn = getattr(importlib.import_module(module), name)
        result = fn(rank, world, **args)
        torch.save(result, out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world, tmp_path, *, timeout=240, **args):
    """``fn(rank, world, **args)`` on ``world`` ranks; returns the list of
    their results (anything ``torch.save`` takes), in rank order. Raises
    with a rank's traceback if one fails, and if the ranks have not all
    ended within ``timeout`` seconds (they are killed then)."""
    tmp_path = pathlib.Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    store = tmp_path / "store"
    if store.exists():
        store.unlink()
    for old in tmp_path.glob("rank*"):
        old.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, str(store), str(tmp_path),
                               fn.__module__, fn.__name__, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: (tmp_path / f"rank{r}.err").read_text()
              for r in range(world) if (tmp_path / f"rank{r}.err").exists()}
    if errors:
        r = min(errors)
        raise RuntimeError(f"rank {r} of {world} failed:\n{errors[r]}")
    if late:
        raise TimeoutError(f"ranks {late} of {world} still ran after "
                           f"{timeout} s and were killed")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]

