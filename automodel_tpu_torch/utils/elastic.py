"""The replica half of elastic recovery: the typed loss, return and
admission events of the serving fleet (counterpart: the exception classes
of ``automodel_tpu/utils/elastic.py``).

:class:`SliceLostError` is what a coordinator's health poll raises for a
lost slice; the fleet (``serving/fleet.py``) maps it to the replica serving
that slice.  The replica events are recorded in the fleet's ``events`` log,
never raised: a loss is absorbed (harvest and replay on the survivors), a
return is an admission, a failed admission leaves the fleet serving
shrunk.  ``ElasticConfig``, ``Rescale`` and the ``ElasticCoordinator``
itself need several processes and wait for ROADMAP Queue 1 item 12; the
fleet takes any object with ``poll(step)``, ``ready_to_readmit()`` and
``admit(slice_id, step)``, as the JAX fleet does.
"""

from __future__ import annotations


def _at(what: str, n: int) -> str:
    return f" at {what} {n}" if n >= 0 else ""


class SliceLostError(RuntimeError):
    """A whole slice is gone (host death, missed heartbeat, preemption).
    ``local=True``: this host belongs to the lost slice."""

    def __init__(self, slice_id: int, reason: str, detected_at_step: int = -1,
                 local: bool = False):
        self.slice_id = slice_id
        self.reason = reason
        self.detected_at_step = detected_at_step
        self.local = local
        super().__init__(
            f"slice {slice_id} lost ({reason})"
            + _at("step", detected_at_step)
            + (" [this host's own slice]" if local else ""))


class _ReplicaEvent(RuntimeError):
    """One fleet event about ``replica_id``, detected at a health poll."""

    verb = ""

    def __init__(self, replica_id: int, reason: str,
                 detected_at_poll: int = -1):
        self.replica_id = replica_id
        self.reason = reason
        self.detected_at_poll = detected_at_poll
        super().__init__(f"serving replica {replica_id} {self.verb} "
                         f"({reason})" + _at("poll", detected_at_poll))


class ReplicaLostError(_ReplicaEvent):
    """A decode replica's slice is gone; the fleet absorbs it (harvest,
    replay on survivors) and records this event."""

    verb = "lost"


class ReplicaReturnedError(_ReplicaEvent):
    """A lost replica passed probation and was admitted again, warmed from
    a live peer's weights (digest-verified)."""

    verb = "readmitted"


class ReplicaAdmitError(_ReplicaEvent):
    """An admission failed (warm-up transport, digest mismatch, the
    drilled ``fleet_replica_admit``): recorded, never raised; the replica's
    probation restarts and the fleet serves shrunk."""

    verb = "admission failed"
