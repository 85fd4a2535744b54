"""Hot-set tiering: the host-RAM shadow table behind the device hot set
(the port of ``gubernator_tpu/tier/``).

The decide path's table must fit device memory, so a table sized for the
hot set would discard the displaced row's state on every live eviction: a
permissive re-grant the next time that key shows up. Tiering turns
eviction into a tiering event:

* **demote-on-evict**: the decide dispatch returns the evicted rows as a
  sidecar riding the response fetch (kernel2 / probe_walk ``evictees=``)
  and the engine appends them to the shadow;
* **demote-on-idle**: an idle sweep pulls rows idle past a horizon out of
  the table (``extract_idle`` + ``tombstone_fps``) into the shadow;
* **fault-back**: host staging probes the shadow for the batch's
  fingerprints; hits leave the shadow and are installed through the
  conservative merge (kernel2.merge2) BEFORE the decide dispatch, so a
  promoted stale row can only under-grant.

Capacity scales with tracked keys (host RAM + an optional spill file)
while decisions/s tracks the hot set. ``tier/manager.py`` (TierManager) is
the daemon's plane over the shadow: it arms the engine, runs the
demote-on-idle sweep and writes the tombstone frames.
"""

from gubernator_tpu_torch.tier.shadow import ROW_BYTES, ShadowTable, merge_canonical_rows  # noqa: F401
