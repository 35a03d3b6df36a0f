"""Render statistics: declarative device counters.

Counterpart of the reference's stats framework (`util/stats.h:19-160`
STAT_COUNTER / STAT_RATIO / distributions with thread-local accumulation).
On a device there are no thread-locals: counters are a dict of scalar device
arrays summed into per-wave, reduced once at the end (and psum'd over the
mesh in the sharded path).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

Array = jax.Array


def make_counters(names: tuple[str, ...]) -> Dict[str, Array]:
    return {n: jnp.zeros((), jnp.float64 if False else jnp.float32) for n in names}


def bump(counters: Dict[str, Array], name: str, amount) -> Dict[str, Array]:
    """Functional counter increment (amount may be a traced scalar)."""
    out = dict(counters)
    out[name] = counters[name] + jnp.asarray(amount, jnp.float32)
    return out


def merge(a: Dict[str, Array], b: Dict[str, Array]) -> Dict[str, Array]:
    return {k: a[k] + b[k] for k in a}


def render_report(counters: Dict[str, Array]) -> str:
    """Formatted report (the --stats print, cmd/pbrt.cpp:199 PrintStats)."""
    lines = ["Statistics:"]
    groups: Dict[str, list] = {}
    for k, v in sorted(counters.items()):
        cat, _, name = k.partition("/")
        groups.setdefault(cat, []).append((name or cat, float(v)))
    for cat, items in groups.items():
        lines.append(f"  {cat}")
        for name, v in items:
            lines.append(f"    {name:<40} {v:,.0f}")
    return "\n".join(lines)


# canonical renderer counters (wavefront/integrator.h:141-149 analog)
RENDER_COUNTERS = (
    "rays/camera rays",
    "rays/indirect rays",
    "rays/shadow rays",
    "intersections/hits",
    "paths/terminated by RR",
    "paths/reached max depth",
)
