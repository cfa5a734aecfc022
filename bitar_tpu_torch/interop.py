"""State carried across from the JAX package.

Both take plain data (numpy arrays, container bytes), so neither imports
the JAX package:

* ``plans_from_reference``: a flat-plan dict of the JAX engine
  (``CompressedUnit.plan_flat``) -> the port's plan tensors on a device,
  ready for ``ops.decode_flat.decode_blocks_flat``.
* ``unit_from_reference``: a container the JAX engine wrote
  (``CompressedBuffers.to_bytes()``) -> a unit of a port engine.
"""

from __future__ import annotations

import numpy as np
import torch

from .manifest import CompressedBuffers
from .ops.decode_flat import LANES, plan_tensors
from .status import Status, StatusError

#: TPU-only entries of the JAX plan dict: banded-gather tables and the VMEM
#: gather height.  The CUDA kernel reads the same wire without them.
TPU_ONLY_PLAN_KEYS = ("bands", "bands_static", "gather_rows")
#: The unit's host scratch in both packages' plan dicts, not plan data: the
#: pooled grant that holds the wire's arrays (returned by ``recycle``).
SCRATCH_PLAN_KEYS = ("_pooled",)


def plans_from_reference(plan_flat: dict, device) -> dict[str, torch.Tensor]:
    """The JAX engine's flat-plan dict as the port's plan tensors.

    Checks the wire's bounds on the host, so a plan that would read past
    its arrays is refused here rather than clamped on the device."""
    if plan_flat.get("lit_planes"):
        raise StatusError(Status.NotImplemented(
            "plan carries zstd literal planes, which replace those blocks' comp "
            "rows; decode such a unit through an engine (unit_from_reference)"))
    plan = {k: v for k, v in plan_flat.items()
            if k not in TPU_ONLY_PLAN_KEYS + SCRATCH_PLAN_KEYS
            and k not in ("lit_planes", "host_blocks")}
    p_used = plan["p_used"].astype(np.int64)
    p_off = plan["p_off"].astype(np.int64)
    rows = plan["se"].shape[0]
    if (p_off < 0).any() or ((p_off + p_used) > rows).any():
        raise StatusError(Status.Invalid("plan passes run past the se/shift wire"))
    if plan["se"].shape[2] != LANES or plan["shift"].shape != plan["se"].shape:
        raise StatusError(Status.Invalid("se/shift must be [S, tiles, 128]"))
    if "dq" in plan:
        dense, di = plan["dense"], plan.get("dq_idx")
        nd = plan["dq"].shape[0]
        if di is not None and ((di < 0) | (di >= nd))[dense > 0].any():
            raise StatusError(Status.Invalid("dq_idx outside the dense wire"))
        if int(dense.max(initial=0)) > plan["row_a"].shape[1]:
            raise StatusError(Status.Invalid("dense pass count exceeds anchor planes"))
    return plan_tensors(plan, device)


def unit_from_reference(container: bytes, engine):
    """Import a container written by the JAX package into ``engine``
    (containers are byte-identical across the two packages)."""
    return engine.import_unit(CompressedBuffers.from_bytes(container))
