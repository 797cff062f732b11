"""Run a function on N ranks of one host: spawned processes in one process
group.

The counterpart of the JAX package's `cpu_test_mesh` (8 virtual devices in
one process): torch.distributed needs one process per rank, so
`run("pkg.module:function", n, args=...)` spawns n processes ("spawn"
start method: a fresh interpreter each, importing the target's module and
nothing of the caller's), joins them in one group through a file store in
a temporary directory (no TCP port to pick, so concurrent callers never
collide), calls the function on every rank and returns each rank's return
value in rank order.  Tensors in a return value come back as numpy arrays
(16-bit floats widened to fp32).

The backend is gloo, which runs on either device (the target picks its
device when it makes its mesh; every rank on one host's card shares it),
and each rank runs torch on one thread.  The group's collectives time out
after `timeout` seconds, and the parent
waits at most that long for the whole run: a rank that raises ends the run
at once (the others are terminated) and `run` raises with that rank's
traceback; a run past its time raises TimeoutError.  Nothing hangs.

`start` posts the run and returns a handle whose `result()` waits, so a
caller can compute something else (the JAX side of a parity test) while
the ranks work.  As with any "spawn" start, a script that calls it runs
the call under `if __name__ == "__main__":`: each rank imports the
caller's main module again (a call at its top level fails every rank).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import tempfile
import time
import traceback


def _numpy(obj):
    """Tensors inside dicts, lists and tuples as numpy arrays."""
    import torch

    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16) or t.dtype.is_floating_point \
                and t.element_size() == 1:
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy(v) for v in obj)
    return obj


def _resolve(target: str):
    module, _, name = target.partition(":")
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _rank_main(rank, world, tmp, timeout):
    """A spawned rank: join the group, call the target with the arguments
    read from `tmp`, write its result (or its traceback) under `tmp`."""
    import torch
    import torch.distributed as dist

    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            target, args = pickle.load(f)
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        result = _numpy(_resolve(target)(*args))
        with open(os.path.join(tmp, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"rank{rank}.pkl.tmp"),
                   os.path.join(tmp, f"rank{rank}.pkl"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Launch:
    """A posted run; `result()` waits for it (see the module's note)."""

    def __init__(self, target: str, world_size: int, args=(),
                 timeout: float = 120.0):
        import torch.multiprocessing as mp

        self.target, self.world, self.timeout = target, world_size, timeout
        self.tmp = tempfile.mkdtemp(prefix="cfa_launch_")
        # The arguments go through a file: a process's start() writes its
        # pickle into a pipe, and one larger than the pipe's buffer would
        # block the start of a child that died before reading it.
        with open(os.path.join(self.tmp, "args.pkl"), "wb") as f:
            pickle.dump((target, tuple(args)), f)
        ctx = mp.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, world_size, self.tmp, timeout))
            for r in range(world_size)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def _failure(self):
        """The first failed rank's traceback (or exit code), or None."""
        for r, p in enumerate(self.procs):
            err = os.path.join(self.tmp, f"rank{r}.err")
            if os.path.exists(err) or (p.exitcode not in (None, 0)):
                p.join(1.0)
                text = open(err).read() if os.path.exists(err) else ""
                return r, text or f"exit code {p.exitcode}"
        return None

    def stop(self):
        """End every rank still running and remove the run's files."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def result(self) -> list:
        try:
            while True:
                failed = self._failure()
                if failed is not None:
                    rank, text = failed
                    raise RuntimeError(
                        f"rank {rank} of {self.world} failed in {self.target}:\n"
                        f"{text}")
                if all(p.exitcode == 0 for p in self.procs):
                    break
                if time.monotonic() - self.t0 > self.timeout:
                    raise TimeoutError(
                        f"{self.target} on {self.world} ranks did not end "
                        f"within {self.timeout:.0f} s")
                time.sleep(0.02)
            out = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.stop()


def start(target: str, world_size: int, *, args=(),
          timeout: float = 120.0) -> Launch:
    """Post `target` ("module:function") on `world_size` ranks; see the
    module's note."""
    return Launch(target, world_size, args, timeout)


def run(target: str, world_size: int, *, args=(),
        timeout: float = 120.0) -> list:
    """`start(...).result()`: each rank's return value, in rank order."""
    return start(target, world_size, args=args, timeout=timeout).result()
