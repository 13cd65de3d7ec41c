"""Start the ranks of a data-parallel run, one process a device.

The JAX package runs one controller over all its devices; PyTorch runs one
process a device.  ``launch(fn, n, device)`` starts ``n`` processes with
``torch.multiprocessing`` under the ``spawn`` start method (a parent that
holds a CUDA context cannot ``fork``), joins them through a ``FileStore``
in a temporary directory (no port is opened), and calls ``fn(*args)`` in
each inside its initialised process group: NCCL with rank ``r`` on card
``r`` for ``device="cuda"``, gloo for ``device="cpu"``.  There is no switch
and no fallback from one backend to the other.  It returns the ranks'
return values in rank order; a rank that raises makes ``launch`` raise
(``RankFailed``, with the rank and its traceback), after every rank has
ended.
"""

from __future__ import annotations

import pickle
import tempfile
import traceback
from pathlib import Path
from typing import Callable

import torch

from .sharding import BACKENDS


class RankFailed(RuntimeError):
    """A rank of a launched group raised."""


def _rank_main(rank: int, fn: Callable, args: tuple, world: int,
               device: str, store_dir: str, threads: int | None) -> None:
    import torch.distributed as dist
    if threads is not None:
        torch.set_num_threads(threads)
    if device == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(str(Path(store_dir) / "store"), world)
    dist.init_process_group(BACKENDS[device], store=store, rank=rank,
                            world_size=world)
    try:
        result = fn(*args)
    except BaseException:
        # kept for the parent: the first rank to fail may end the others
        # before its own traceback reaches it
        (Path(store_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    (Path(store_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


def launch(fn: Callable, n: int, device: str = "cuda", args: tuple = (),
           threads: int | None = None, store_dir: str | None = None) -> list:
    """Run ``fn(*args)`` in ``n`` ranks on ``device`` ("cuda": one card a
    rank, NCCL; "cpu": gloo) and return their results in rank order.
    ``fn`` and ``args`` must pickle (a module-level function);
    ``threads`` caps each rank's torch threads; ``store_dir`` holds the
    ``FileStore`` and the results (default: a temporary directory).  A
    rank that raises or dies ends the others and raises ``RankFailed``
    here, with its traceback."""
    import torch.multiprocessing as mp
    device = torch.device(device).type
    if device not in BACKENDS:
        raise ValueError(f"no data-parallel backend for device {device}")
    if n < 1:
        raise ValueError(f"launch needs at least one rank, not {n}")
    if device == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks on {torch.cuda.device_count()} cards: "
                         "NCCL takes one card a rank")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, n, device, tmp, threads), nprocs=n,
            join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except Exception as e:     # a rank raised or died: the rest ended
            said = [f"rank {r}:\n" + (Path(tmp) / f"rank{r}.err").read_text()
                    for r in range(n) if (Path(tmp) / f"rank{r}.err").exists()]
            raise RankFailed("\n".join(said) or str(e)) from None
        return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                for r in range(n)]
