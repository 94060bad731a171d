"""ResourceDemandScheduler — bin-pack unfulfilled demand over node types.

Reference: autoscaler/_private/resource_demand_scheduler.py:101,169
(get_nodes_to_launch): subtract what the live cluster (plus already-launching
nodes) can absorb, then greedily pick node types for what remains, respecting
per-type max_workers. Placement-group bundles are strategy-aware: STRICT_SPREAD
consumes one distinct host per bundle (numerically fitting on fewer nodes is
NOT enough — the controller's placer will refuse it), STRICT_PACK needs one
host for the bundle sum, PACK/SPREAD bin-pack freely.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

_EPS = 1e-9


def _fits(avail: dict, demand: dict) -> bool:
    return all(avail.get(k, 0.0) + _EPS >= v for k, v in demand.items())


def _consume(avail: dict, demand: dict) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


def _sum_bundles(bundles: Sequence[dict]) -> dict:
    out: dict = {}
    for b in bundles:
        for k, v in b.items():
            out[k] = out.get(k, 0.0) + v
    return out


class ResourceDemandScheduler:
    def __init__(self, node_types: Dict[str, dict]):
        self.node_types = node_types

    def get_nodes_to_launch(
        self,
        node_avail: List[dict],
        demands: List[dict],
        bundle_sets: List[Tuple[str, List[dict]]],
        current_counts: Dict[str, int],
    ) -> Dict[str, int]:
        """Returns {node_type: count} to launch. `node_avail` is the available
        resource vector of each live (or already-launching) node;
        `current_counts` counts live nodes per type (for max_workers caps);
        `bundle_sets` carries (strategy, bundles) per pending PG."""
        pool: List[dict] = [dict(a) for a in node_avail]
        to_launch: Dict[str, int] = {}
        counts = dict(current_counts)

        def launch_for(demand: dict) -> bool:
            """Add capacity for `demand`; returns True if a type was found.
            New hosts join `pool` so later demands can share them."""
            for type_name, cfg in self.node_types.items():
                resources = cfg.get("resources", {})
                max_workers = int(cfg.get("max_workers", 2**31))
                hosts = int(cfg.get("hosts_per_slice", 1))
                if counts.get(type_name, 0) >= max_workers:
                    continue
                if not _fits(dict(resources), demand):
                    continue
                counts[type_name] = counts.get(type_name, 0) + 1
                to_launch[type_name] = to_launch.get(type_name, 0) + 1
                for _ in range(hosts):
                    pool.append(dict(resources))
                return True
            return False

        def place(demand: dict, exclude: set) -> int:
            """Consume `demand` from a pool host not in `exclude`;
            returns the host index or -1."""
            for idx, a in enumerate(pool):
                if idx in exclude:
                    continue
                if _fits(a, demand):
                    _consume(a, demand)
                    return idx
            return -1

        for demand in demands:
            if not demand:
                continue
            if place(demand, set()) < 0 and launch_for(demand):
                place(demand, set())

        for strategy, bundles in bundle_sets:
            if strategy == "STRICT_PACK":
                total = _sum_bundles(bundles)
                if place(total, set()) < 0 and launch_for(total):
                    place(total, set())
                continue
            # STRICT_SPREAD: every bundle on a distinct host. PACK/SPREAD can
            # share hosts, but placing them distinctly is also always valid —
            # so one code path covers all spread-y strategies without
            # underestimating strict requirements.
            used: set = set()
            distinct = strategy in ("STRICT_SPREAD", "SPREAD")
            for bundle in bundles:
                idx = place(bundle, used if distinct else set())
                if idx < 0:
                    if launch_for(bundle):
                        idx = place(bundle, used if distinct else set())
                if idx >= 0 and distinct:
                    used.add(idx)
        return to_launch
