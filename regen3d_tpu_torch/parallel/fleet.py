"""Multi-scene fleet: many scenes through the phase pipeline (counterpart of
regen3d_tpu/parallel/fleet.py).

N independent scenes run the phases with their own configs. The scene list
is split over the ranks of a ``torch.distributed`` process group (round
robin), each rank runs its scenes one after another on its card, and phase
sets that only read and write files (within {1, 2, 8, 9}) overlap scenes in
a thread pool. A failing scene fails alone. Ranks that run different scenes
share no collective, so under a group of several ranks phase 6 fits each
scene's objects on its own rank (``shard_pose_fit`` false).
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.orchestrator import run_phases

log = logging.getLogger(__name__)

# phase sets of these phases run scenes in a thread pool
IO_PHASES = frozenset({1, 2, 8, 9})


@dataclass
class SceneJob:
    scene_id: str
    input_image: str
    output_root: str
    overrides: Optional[dict] = None


@dataclass
class FleetResult:
    scene_id: str
    ok: bool
    seconds: float
    error: Optional[str] = None


def shard_jobs(jobs: Sequence[SceneJob], pidx: int,
               pcount: int) -> List[SceneJob]:
    """Rank ``pidx`` of ``pcount`` takes every pcount-th job (round robin,
    so a list sorted by cost balances). The union over all ranks is exactly
    ``jobs``, and the shares are disjoint."""
    if not 0 <= pidx < pcount:
        raise ValueError(f"process index {pidx} not in [0, {pcount})")
    return [j for i, j in enumerate(jobs) if i % pcount == pidx]


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_fleet(
    jobs: Sequence[SceneJob],
    phases: Sequence[int] = tuple(range(1, 10)),
    io_workers: int = 4,
    base_overrides: Optional[dict] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    device="cuda",
) -> List[FleetResult]:
    """Run the phases over many scenes; a result per scene of this rank.

    ``process_index`` / ``process_count`` default to the process group's
    rank and world size (0 and 1 without a group); tests inject values to
    run one rank's share. A scene's failure is caught, logged with its
    traceback and returned as its result (the reference stops on a failure
    within a scene, not across the fleet). Before the thread pool starts,
    the CUDA kernels are built and loaded, so that no two scenes build them
    at once. Where several ranks run (a group, or an injected count), the
    ranks' scenes differ and phase 6 fits each scene on its own rank; a
    scene that asks for ``shard_pose_fit`` then fails with a ValueError."""
    rank, world = _rank_and_world()
    pidx = rank if process_index is None else process_index
    pcount = world if process_count is None else process_count
    local_fit = world > 1 or pcount > 1
    mine = shard_jobs(jobs, pidx, pcount)
    log.info("fleet: rank %d/%d takes %d/%d scenes", pidx, pcount,
             len(mine), len(jobs))

    def one(job: SceneJob) -> FleetResult:
        t0 = time.time()
        try:
            overrides = dict(base_overrides or {})
            overrides.update(job.overrides or {})
            if local_fit:
                if overrides.get("shard_pose_fit"):
                    raise ValueError(
                        "shard_pose_fit: the fleet runs a different scene on "
                        "each rank, so phase 6 cannot split one scene's "
                        "objects over them")
                overrides["shard_pose_fit"] = False
            overrides["input_image"] = job.input_image
            cfg = default_config(job.output_root, **overrides)
            run_phases(cfg, list(phases), device=device)
            return FleetResult(job.scene_id, True, time.time() - t0)
        except Exception as e:  # scene isolation
            log.exception("fleet: scene %s failed", job.scene_id)
            return FleetResult(job.scene_id, False, time.time() - t0, str(e))

    if set(phases) <= IO_PHASES:
        if torch.device(device).type == "cuda":
            from regen3d_tpu_torch import kernels

            kernels.load_all()
        with ThreadPoolExecutor(max_workers=io_workers) as pool:
            results = list(pool.map(one, mine))
    else:
        results = [one(j) for j in mine]

    log.info("fleet: %d/%d scenes ok", sum(r.ok for r in results),
             len(results))
    return results
