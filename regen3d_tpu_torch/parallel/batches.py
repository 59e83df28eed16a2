"""The trainers' batches, drawn ahead in a worker process.

``BatchStream(fn, seed, init_args, args, steps, process)`` gives step i's
batch as ``sample(i)``: the i-th call of ``fn(rng, *args)`` with
``rng = np.random.default_rng(seed)``, after one call of
``fn(rng, *init_args)`` (the batch the JAX trainer draws for its init).
The draws are the JAX trainers', in their order.

The generators are numpy loops that hold the interpreter while they run,
so drawn in the training process they delay the launches of the steps.
With ``process`` they run in a worker, a fresh interpreter started as
``python -m regen3d_tpu_torch.parallel.batches`` (not a fork of a process
that may hold a CUDA context, and not a re-run of the caller's main
module, as multiprocessing's spawn would do), which writes each batch,
pickled, to a pipe that blocks it a batch or two ahead. ``fn`` must be a
module-level function.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<Q")


def _write(stream, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_HEADER.pack(len(data)))
    stream.write(data)
    stream.flush()


def _read(stream):
    head = stream.read(_HEADER.size)
    if len(head) < _HEADER.size:
        raise RuntimeError("the batch worker ended early")
    (n,) = _HEADER.unpack(head)
    return pickle.loads(stream.read(n))


class BatchStream:
    """Step i's batch of a trainer as ``sample(i)`` (see the module). Use
    as a context manager: ``close`` ends the worker."""

    def __init__(self, fn, seed: int, init_args, args, steps: int,
                 process: bool):
        self.proc = None
        if not process:
            self.rng = np.random.default_rng(seed)
            if init_args is not None:
                fn(self.rng, *init_args)
            self.fn, self.args = fn, args
            return
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "regen3d_tpu_torch.parallel.batches"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        _write(self.proc.stdin, (fn.__module__, fn.__qualname__, seed,
                                 init_args, args, steps))
        self.proc.stdin.close()

    def __call__(self, i: int):
        if self.proc is None:
            return self.fn(self.rng, *self.args)
        kind, item = _read(self.proc.stdout)
        if kind == "error":
            raise RuntimeError(f"the batch worker failed:\n{item}")
        return item

    def close(self) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            self.proc.stdout.close()
            self.proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _worker() -> None:
    """The worker: reads (module, function, seed, init_args, args, steps)
    from stdin and writes ("batch", batch) records, then exits; a failure
    is written as ("error", traceback)."""
    import importlib

    out = sys.stdout.buffer
    try:
        mod, name, seed, init_args, args, steps = _read(sys.stdin.buffer)
        fn = getattr(importlib.import_module(mod), name)
        rng = np.random.default_rng(seed)
        if init_args is not None:
            fn(rng, *init_args)
        for _ in range(steps):
            _write(out, ("batch", fn(rng, *args)))
    except BrokenPipeError:
        pass
    except BaseException:
        _write(out, ("error", traceback.format_exc()))


if __name__ == "__main__":
    _worker()
