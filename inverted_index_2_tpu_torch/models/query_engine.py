"""Batched query serving over a frozen snapshot on a torch device
(counterpart of models/query_engine.py).

QueryEngine.from_index(index, L) freezes the index into compact host
tables, uploads them to the card (one gather expands the block arena), and
serves
    lookup(terms)                   resolve -> K1 decode -> ladder re-serve
    boolean(queries, "and")         resolve -> reorder -> K2 fused AND
    boolean(queries, "or")          the concat classes (below)
    boolean_staged(batches, op)     the same, depth-pipelined (staged.py)
    lookup_staged(batches)          single-term OR through the concat stream
    read_range(min, max)            sorted (term, postings) stream
    prefix_search(prefixes)         the union of every term under a prefix
Lists longer than the fast-path pad L are re-served exactly at the
smallest ladder level (4L, 16L, ...) that fits; a base list above the
largest level K2 takes (cuda_fused.MAX_LEVEL) goes to the concat AND. The
concat classes (ops/concat_bool.py) size each query by its total postings
and sort through K4; they serve OR, pagination (prefix_p) and staged
lookup.

With the compact host tables retained (keep_tables, the default) the
engine has a second route, on the host (models/host_serve.py): a hash
probe and a native decode of the compressed stream, no device at all.
lookup_staged, read_range and prefix_search always take it then (they are
pure output); boolean and boolean_staged take it by the router
(_host_boolean_route), which reads a measured host<->card link rate, the
host's load, and the knobs TPI_HOST_BOOL=or|and|all|0|auto and TPI_HYBRID=1.
The router never takes the host because the card failed: a missing CUDA, a
kernel that does not build or a launch that fails raises.

refresh(index) keeps the engine current while the index takes writes: an
additive change becomes a small DELTA snapshot beside the untouched main
one, and while a delta is live every boolean and staged call serves the
padded dual step (steps.boolean_step_dual: K1 decode of both tiers, the
pair union, the AND through K3), and lookup unions both tiers. A delta
above DELTA_FRACTION of main folds into a new main; a compaction rebuilds.

from_checkpoint(path) starts from tables saved by models/checkpoint.py and
serves them on the host at once while the arena uploads on a side CUDA
stream; the uploaded snapshot is published in one assignment when it has
landed (device_ready, device_wait). With checkpoint_path set, every main
tier rebuild saves the tables again.

The same serving over partitions of the index on several devices, or
several partitions of one card, is parallel/mesh_engine.MeshQueryEngine.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..codec import keys as keys_mod
from ..ops import _build
from ..ops.cuda_concat import concat_step
from ..ops.cuda_decode import decode_postings
from ..ops.cuda_fused import MAX_LEVEL
from ..ops.dict_search import searchsorted_rows
from ..shard import merge_views
from ..utils import tracing
from ..utils.u32 import to_device, to_numpy_u32
from .host_serve import HostServingMixin
from .snapshot import (
    HostTables,
    IndexSnapshot,
    _collect_removed,
    _empty_snapshot,
    _index_fingerprint,
    _SnapshotTier,
    build_host_tables,
    snapshot_new_segments,
    snapshot_tables,
    upload_on_side_stream,
    upload_tables,
)
from .staged import StagedStreamsMixin
from .steps import (
    _RESERVE_BUDGET,
    _dedup_adjacent,
    _ladder,
    _narrow_keys,
    _pack_queries,
    _resolve_sb_step,
    _round_up,
    boolean_fused_staged_step,
    boolean_fused_step,
    boolean_step_dual,
    lookup_step,
    prefix_range_step,
)

_LINK_MBPS: Optional[float] = None


def _link_mbps(device) -> float:
    """The host<->card link rate the router reads, in MiB/s (2**20 bytes a
    second, as the JAX package's probe reads it), probed once per process
    (_probe_link); TPI_LINK_MBPS pins it, in the same unit. A CPU engine's
    tensors are host memory, so nothing crosses a link: its rate is
    infinite."""
    global _LINK_MBPS
    if _LINK_MBPS is None:
        pinned = os.environ.get("TPI_LINK_MBPS")
        if pinned is not None:
            _LINK_MBPS = float(pinned)
        elif torch.device(device).type != "cuda":
            return math.inf
        else:
            _LINK_MBPS = _probe_link(torch.device(device))
    return _LINK_MBPS


def _probe_link(dev: torch.device) -> float:
    """Pinned host buffers of 4 MiB and 4 KiB copied to the card and back
    with non_blocking copies and a synchronize, best of 2 runs each; the
    small one's time (the latency) is taken off the large one's. The bytes
    cross the link twice: 2 * nbytes / dt."""
    def best(nwords: int) -> float:
        src = torch.zeros(nwords, dtype=torch.int32).pin_memory()
        back = torch.empty(nwords, dtype=torch.int32, pin_memory=True)
        t = math.inf
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            back.copy_(src.to(dev, non_blocking=True), non_blocking=True)
            torch.cuda.synchronize(dev)
            t = min(t, time.perf_counter() - t0)
        return t

    nbytes = (1 << 22) - (1 << 12)
    dt = max(best(1 << 20) - best(1 << 10), 1e-6)
    return 2 * nbytes / dt / 2**20


class ServingState:
    """One immutable bundle of everything a serve path reads: the main and
    delta snapshots, the tombstone array, the retained host tables and the
    freeze fingerprints. refresh() builds a whole new bundle and publishes
    it with one reference assignment, and every entry point captures one
    reference up front, so a reader sees the old state or the new one,
    never a new main beside a stale delta or stale tombstones."""

    __slots__ = ("snap", "delta", "removed", "tables", "delta_tables",
                 "fingerprint", "main_fp", "_removed_host", "device_ready")

    def __init__(self, snap: IndexSnapshot,
                 delta: Optional[IndexSnapshot] = None,
                 removed: Optional[torch.Tensor] = None,
                 tables: Optional[HostTables] = None,
                 delta_tables: Optional[HostTables] = None,
                 fingerprint=None, main_fp=None,
                 removed_host: Optional[np.ndarray] = None,
                 device_ready: bool = True):
        self.snap = snap
        self.delta = delta
        self.removed = removed
        self.tables = tables
        self.delta_tables = delta_tables
        self.fingerprint = fingerprint
        self.main_fp = main_fp
        self._removed_host = removed_host
        # False only in a warm checkpoint start's window: `snap` is an
        # empty placeholder while the arena uploads, and every entry point
        # serves from the retained tables until the upload is published
        self.device_ready = device_ready

    def replace(self, **kw) -> "ServingState":
        """A copy with the given fields replaced (the rest shared)."""
        args = {"delta": self.delta, "removed": self.removed,
                "tables": self.tables, "delta_tables": self.delta_tables,
                "fingerprint": self.fingerprint, "main_fp": self.main_fp,
                "removed_host": self._removed_host,
                "device_ready": self.device_ready}
        snap = kw.pop("snap", self.snap)
        args.update(kw)
        return ServingState(snap, **args)

    def removed_host(self) -> Optional[np.ndarray]:
        """Host copy of the tombstone array (lazy; racing calls compute the
        same value)."""
        rh = self._removed_host
        if rh is None and self.removed is not None:
            rh = to_numpy_u32(self.removed)
            self._removed_host = rh
        return rh

    def host_ready(self) -> bool:
        """Retained host tables cover both tiers."""
        return self.tables is not None and (
            self.delta is None or self.delta_tables is not None)

    def max_count(self) -> int:
        m = self.snap.max_count
        if self.delta is not None:
            m += self.delta.max_count  # a term's union can reach the sum
        return m

    def width(self) -> int:
        """Query key width across the live tiers."""
        w = self.snap.width
        if self.delta is not None:
            w = max(w, self.delta.width)
        return w

    def host_q_width(self) -> int:
        """Query key width across the retained tables."""
        w = self.tables.width
        if self.delta_tables is not None:
            w = max(w, self.delta_tables.width)
        return w


class QueryEngine(HostServingMixin, StagedStreamsMixin):
    """Batched lookup, AND, OR, range and prefix serving over a frozen
    IndexSnapshot on `device` (the card unless the caller asks for the
    CPU), with a host route over the retained tables. L is the fast-path
    pad: longer lists re-serve exactly at a ladder level."""

    # a delta with more terms than this fraction of main folds into a new
    # main (the serving analogue of an LSM compaction)
    DELTA_FRACTION = 0.25

    # one-shot boolean() batches at least this large go through the staged
    # stream (same contract, pipelined)
    _STAGED_DELEGATE_MIN = 512

    # first results shipped with the counts by the one-shot fused pass; the
    # rare wider rows re-run through the sort path
    _FUSED_SMALL_P = 32

    # the stream's narrower result prefix (same overflow rule)
    _STAGED_SMALL_P = 8

    # term rows a range read decodes at a time
    _RANGE_CHUNK = 4096

    # The router's link thresholds in MiB/s (_host_boolean_route): auto takes
    # the host route for an op while the probed link (_link_mbps) is below
    # the op's threshold. Both are set from the two routes measured side by
    # side at the config-3 size (chip_smoke.py phase 5, "host route at full
    # width", 8 batches of 8192; NVIDIA H100 80GB HBM3, 700.00 W), where the
    # probe read 41,172.6 to 53,309.0 MiB/s in four runs.
    # AND: the device route was faster, 225,038.3 and 509,093.0 QPS against
    # the host's 133,584.5 and 159,521.2 (uniform; Zipf 331,688.1 against
    # 346,980.7, then 567,833.6 against 375,663.8), so the threshold lies
    # below the probe: 1,000 MiB/s, ten times what the device stream moves
    # at 509k QPS (about 170 bytes a query: the packed keys up, an 8-lane
    # page and its codes down). No slower link was measured, so where AND
    # crosses over is an estimate.
    _HOST_ROUTE_LINK_MBPS = 1000.0        # AND, staged and one-shot
    # Full-result OR: the host route was faster, 39,564.3 and 44,060.7 QPS
    # against the device's 9,915.5 and 11,851.2, whose wall is its harvest
    # on the host, not the link; so the threshold lies above the probe and
    # above any host link (about 1 TB/s): full-result OR is served on the
    # host.
    _HOST_ROUTE_OR_LINK_MBPS = 1_000_000.0

    def __init__(self, snapshot: IndexSnapshot, L: int = 1024,
                 tables: Optional[HostTables] = None, *, device="cuda",
                 checkpoint_path: Optional[str] = None,
                 checkpoint_async: bool = True):
        want = torch.device(device)
        have = snapshot.device
        if want.type not in ("cuda", "cpu"):
            raise ValueError(f"device {want}: the port serves on CUDA (kernels "
                             "K1-K4) or on the CPU (their plain versions)")
        if have.type != want.type or want.index not in (None, have.index):
            raise ValueError(f"snapshot lives on {have}, engine device is "
                             f"{want}")
        self.device = have
        self._state = ServingState(
            snapshot, removed=snapshot.removed, tables=tables,
            removed_host=tables.removed if tables is not None else None)
        # writers (refresh, promotion, the warm upload's swap) serialize
        # here; serve paths never take it: they read self._state once
        self._refresh_lock = threading.Lock()
        self.L = max(128, _round_up(L, 128))
        self._staged_levels_cache = None
        self.last_stream_stats = None  # set by boolean/lookup_staged
        # with a path, every main tier rebuild saves the tables there (a
        # delta-only refresh does not: the file reconciles at load)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_async = checkpoint_async
        self._ckpt_lock = threading.Lock()
        self._ckpt_thread: Optional[threading.Thread] = None
        # the router's load signal: the source index's is_busy (_host_busy)
        self._busy_fn: Optional[Callable[[], bool]] = None
        # a warm checkpoint start's background upload (device_wait)
        self._upload_thread: Optional[threading.Thread] = None
        self._upload_error: Optional[BaseException] = None
        self.upload_seconds: Optional[float] = None

    @classmethod
    def from_index(cls, index, L: int = 1024, apply_removed: bool = False,
                   keep_tables: bool = True, *, device="cuda", **kw):
        """Freeze `index` and serve it on `device`. keep_tables retains the
        compact host tables (the host route, and the concat classes resolve
        on the host); pass False to drop them. kw: checkpoint_path,
        checkpoint_async. The freeze's fingerprint is recorded for
        refresh()."""
        fp = _index_fingerprint(index, apply_removed)
        t = snapshot_tables(index, apply_removed=apply_removed)
        eng = cls(upload_tables(t, device=device), L=L,
                  tables=t if keep_tables else None, device=device, **kw)
        eng._publish(eng._state.replace(fingerprint=fp, main_fp=fp))
        eng._busy_fn = getattr(index, "is_busy", None)
        eng._save_ckpt(t, fp)
        return eng

    @classmethod
    def from_checkpoint(cls, path: str, index=None, L: int = 1024,
                        keep_tables: bool = True, *, device="cuda",
                        warm_serve: bool = True, **kw):
        """Start from a checkpoint written by models/checkpoint.py (by
        either package): load the compact host tables and upload them,
        skipping from_index's segment scan, merge, re-encode and hash build.

        With `index`, the checkpoint is reconciled against the live index
        through refresh(): an unchanged fingerprint costs nothing, additive
        drift makes a delta tier, a merge or (under apply_removed) a
        tombstone change rebuilds. Without it, the checkpointed state
        serves as it is. kw: checkpoint_path (pass the same path to keep the
        file current on every later rebuild), checkpoint_async.

        warm_serve (with keep_tables): the engine serves from the host
        tables as soon as they load, while the arena uploads on a side CUDA
        stream from pinned memory (upload_on_side_stream); every entry point
        takes the host route until the uploaded snapshot is published
        (device_ready()), and the results are the same either side of the
        swap. device_wait() blocks until then and raises the upload's
        error, if it failed. Without keep_tables the upload is synchronous:
        there would be nothing to serve from."""
        from .checkpoint import load_checkpoint, load_fingerprint

        t, meta = load_checkpoint(path)
        fp = load_fingerprint(meta)
        if not (warm_serve and keep_tables) or t.n_terms == 0:
            eng = cls(upload_tables(t, device=device), L=L,
                      tables=t if keep_tables else None, device=device, **kw)
            eng._publish(eng._state.replace(fingerprint=fp, main_fp=fp))
        else:
            eng = cls(_empty_snapshot(t.width or 1, device), L=L, tables=t,
                      device=device, **kw)
            host_st = eng._state.replace(fingerprint=fp, main_fp=fp,
                                         device_ready=False)
            eng._publish(host_st)
            eng._start_upload(t, host_st)
        if index is not None:
            eng._busy_fn = getattr(index, "is_busy", None)
            eng.refresh(index, apply_removed=bool(meta["apply_removed"]))
        return eng

    def _start_upload(self, t: HostTables, host_st: ServingState) -> None:
        """The warm start's upload, on a thread: tables `t` go to the card
        on a side stream, and the snapshot is published only if no refresh
        has published a newer state meanwhile."""
        dev = self.device
        serve = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def run():
            t0 = time.perf_counter()
            try:
                snap = (upload_tables(t, device=dev) if serve is None
                        else upload_on_side_stream(t, dev, serve))
            except BaseException as e:  # raised again by device_wait
                self._upload_error = e
                return
            with self._refresh_lock:
                if self._state is host_st:
                    self._publish(host_st.replace(
                        snap=snap, removed=snap.removed, device_ready=True))
            self.upload_seconds = time.perf_counter() - t0

        # not a daemon: the interpreter joins it at exit, so an upload
        # still in torch code never meets torch's static destructors (which
        # abort the process, "terminate called without an active exception")
        th = threading.Thread(target=run, name="tpi-ckpt-upload")
        self._upload_thread = th
        th.start()

    def _serving_state(self) -> ServingState:
        """The state an entry point serves from. A warm start whose upload
        failed raises here, on every entry point, instead of serving the
        host route on for good because the card failed."""
        st = self._state
        err = self._upload_error
        if not st.device_ready and err is not None:
            raise RuntimeError(
                f"the warm start's upload to {self.device} failed: "
                f"{err!r}") from err
        return st

    def device_ready(self) -> bool:
        """False only in a warm checkpoint start's upload window."""
        return self._state.device_ready

    def device_wait(self) -> None:
        """Block until a warm start's upload has been published (no-op
        otherwise); raises the upload's error if it failed."""
        th = self._upload_thread
        if th is not None:
            th.join()
        if self._upload_error is not None:
            raise self._upload_error

    def save_checkpoint(self, index, path: str,
                        apply_removed: bool = False) -> dict:
        """Persist the index's current state as a checkpoint (frozen anew
        from the live index, key width derived from its terms)."""
        from .checkpoint import save_checkpoint

        return save_checkpoint(index, path, apply_removed=apply_removed)

    def _save_ckpt(self, tables: HostTables, fp) -> None:
        """Save `tables` at checkpoint_path, on a thread unless
        checkpoint_async is False. Saves take turns on a lock, and the
        .tmp + rename publish never shows a reader a torn file."""
        if self.checkpoint_path is None:
            return
        from .checkpoint import save_tables

        apply_removed = bool(fp[0]) if fp is not None else False

        def run():
            with self._ckpt_lock:
                save_tables(tables, self.checkpoint_path, fingerprint=fp,
                            apply_removed=apply_removed)

        if self.checkpoint_async:
            # not a daemon, as the upload: a save finishes before exit
            th = threading.Thread(target=run, name="tpi-ckpt-save")
            th.start()
            self._ckpt_thread = th
        else:
            run()

    def checkpoint_wait(self) -> None:
        """Block until a background checkpoint save has been published."""
        th = self._ckpt_thread
        if th is not None:
            th.join()

    # -- serving-state access (introspection and tests; serve paths read
    # self._state once and pass it down) -----------------------------------

    @property
    def snap(self) -> IndexSnapshot:
        return self._state.snap

    @property
    def delta(self) -> Optional[IndexSnapshot]:
        return self._state.delta

    @property
    def tables(self) -> Optional[HostTables]:
        return self._state.tables

    @property
    def delta_tables(self) -> Optional[HostTables]:
        return self._state.delta_tables

    @property
    def _fingerprint(self):
        return self._state.fingerprint

    @property
    def _main_fp(self):
        return self._state.main_fp

    def _publish(self, st: ServingState) -> None:
        """Swap the serving state: one reference assignment, atomic under
        the GIL, so a reader in flight keeps the whole old state."""
        self._state = st

    # -- refresh -----------------------------------------------------------

    def refresh(self, index, apply_removed: bool = False) -> bool:
        """Bring the engine up to date with the live index; False when it
        is unchanged since the last freeze. Queries keep serving the old
        state until the new one is published.

        An additive change (every segment of the main freeze still live,
        and, under apply_removed, the tombstones unchanged) freezes only
        the new segments into a DELTA snapshot; main is not touched. A
        delta above DELTA_FRACTION of main folds both tiers into a new
        main (_promote_delta); a compaction, or a tombstone change under
        apply_removed, rebuilds from the index. The key width is derived
        anew on every rebuild, so longer new terms cannot alias. A rebuild
        saves the checkpoint (checkpoint_path).

        In a warm start's upload window an unchanged index returns False at
        once; a changed one waits for the upload first, so the new state
        builds on the uploaded snapshot, not on the placeholder."""
        if self._upload_thread is not None and not self._state.device_ready:
            if _index_fingerprint(index, apply_removed) == \
                    self._serving_state().fingerprint:
                return False
            self.device_wait()
        with self._refresh_lock:
            base = self._state
            fp = _index_fingerprint(index, apply_removed)
            if fp == base.fingerprint:
                return False
            if base.fingerprint is not None and self._try_delta_refresh(
                    index, fp, apply_removed):
                return True
            t = snapshot_tables(index, apply_removed=apply_removed)
            self._publish_main(base, t, fp)
            return True

    def _publish_main(self, base: ServingState, t: HostTables, fp) -> None:
        """Publish a new main tier built from tables `t`, with no delta,
        and save it as the checkpoint."""
        snap = upload_tables(t, device=self.device)
        keep = base.tables is not None
        self._publish(ServingState(
            snap, removed=snap.removed, tables=t if keep else None,
            removed_host=t.removed if keep else None,
            fingerprint=fp, main_fp=fp))
        self._save_ckpt(t, fp)

    def _try_delta_refresh(self, index, fp, apply_removed: bool) -> bool:
        """The O(delta) refresh; publishes the new state and returns True
        when it applies. Runs under _refresh_lock."""
        base = self._state
        main_fp = base.main_fp
        if main_fp is None or main_fp[0] != apply_removed:
            return False
        main_shards = {k: (segs, rl) for k, segs, rl in main_fp[1]}
        for key, segs, rl in fp[1]:
            base_segs, base_rl = main_shards.get(key, ((), 0))
            if not set(base_segs).issubset(segs):
                return False  # a main segment was merged away
            if apply_removed and rl != base_rl:
                return False  # the purge baseline changed
        base_map = {k: frozenset(segs) for k, segs, _ in main_fp[1]}
        # under apply_removed main was purged at build: purge the delta
        # against the same (unchanged, checked above) tombstones
        rem = _collect_removed(index) if apply_removed else None
        keep = base.tables is not None
        built = snapshot_new_segments(index, base_map, removed=rem,
                                      with_tables=keep, device=self.device)
        if built is None:
            # nothing new survives (e.g. only tombstones): keep the tiers,
            # refresh the tombstone array below
            delta, dt = base.delta, base.delta_tables
        else:
            delta, dt = built if keep else (built, None)
            if delta.n_terms > self.DELTA_FRACTION * max(1, base.snap.n_terms):
                return self._promote_delta(index, fp, apply_removed, delta)
        removed, removed_host = base.removed, base._removed_host
        if not apply_removed:
            removed_host = _collect_removed(index)
            removed = to_device(removed_host, self.device)
        self._publish(base.replace(
            delta=delta, delta_tables=dt, removed=removed,
            removed_host=removed_host, fingerprint=fp))
        return True

    def _promote_delta(self, index, fp, apply_removed: bool, delta) -> bool:
        """Fold an oversized delta into main by merging the two snapshots'
        own arrays (decoded on the device through K1, one two-way key
        merge, re-encoded): equal to a rebuild from the index under this
        path's preconditions (every main segment live; tombstones unchanged
        under apply_removed), without re-reading a segment."""
        base = self._state
        merged = merge_views([_SnapshotTier(base.snap, self),
                              _SnapshotTier(delta, self)], None)
        if merged is None:  # both tiers empty
            return False
        blob, offsets, values, voffs = merged
        rem = None if apply_removed else _collect_removed(index)
        self._publish_main(
            base, build_host_tables(blob, offsets, values, voffs, rem), fp)
        return True

    def _decode_indices(self, idx: np.ndarray, s: IndexSnapshot,
                        st: Optional[ServingState] = None):
        """Exact postings of dictionary indexes `idx` in snapshot `s`:
        (values, voffs[n+1]). Rows decode through K1 in batches grouped by
        the smallest ladder level that holds each row's count (the ladder
        of `st`, else of `s` alone)."""
        counts = s.host_counts[idx].astype(np.int64)
        voffs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=voffs[1:])
        flat = np.empty(int(voffs[-1]), dtype=np.uint32)
        if len(idx) == 0:
            return flat, voffs
        ladder = (self._levels(st) if st is not None
                  else _ladder(self.L, s.max_count))
        levels = np.array([self.L] + ladder, dtype=np.int64)
        lvl_idx = np.searchsorted(levels, counts, side="left")
        for li in np.unique(lvl_idx):
            lv = int(levels[li])
            sel = np.nonzero(lvl_idx == li)[0]
            qb = max(1, _RESERVE_BUDGET // lv)
            for c0 in range(0, len(sel), qb):
                ss = sel[c0: c0 + qb]
                v, _ = decode_postings(s.blocks, s.term_block_start, s.counts,
                                       self._dev(idx[ss].astype(np.int32)),
                                       lv)
                w = min(max(1, int(counts[ss].max())), lv)
                v = to_numpy_u32(v[:, :w])
                m = np.arange(w)[None, :] < counts[ss][:, None]
                dst = (voffs[ss][:, None] + np.arange(w)[None, :])[m]
                flat[dst] = v[m]
        return flat, voffs

    def _levels(self, st: Optional[ServingState] = None) -> List[int]:
        st = st if st is not None else self._state
        return _ladder(self.L, st.max_count())

    def _level_for(self, need: int, st: Optional[ServingState] = None) -> int:
        for lv in self._levels(st):
            if lv >= need:
                return lv
        return _round_up(need, 128)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        # a copy from pageable memory: on the card the host waits in it for
        # every kernel queued before it
        with tracing.span("tpi.upload"):
            return to_device(a, self.device)

    # -- warmup and stats --------------------------------------------------

    def warmup(self, k_max: int = 8, ops: Sequence[str] = ("and", "or")) -> int:
        """Get the serving paths ready before traffic arrives. Nothing here
        compiles at serve time, so on the card this builds (or loads) the
        kernel library and runs each path once on a batch of 8 empty
        queries: the lookup, the resolve, each concat class a query of
        k_max terms of this corpus can reach for each op, and for AND K2 in
        its one-shot and staged forms, with and without the tombstone
        filter when tombstones exist. Returns the number of paths run,
        counted as the JAX engine counts the programs it compiles (with its
        fused AND on)."""
        st = self._serving_state()
        s = st.snap
        if s.n_terms == 0:
            return 0
        if self.device.type == "cuda":
            _build.library()
        Q = 8
        self._lookup_on(s, self._dev(np.zeros((Q, s.width + 1), np.uint32)),
                        None)
        n = 1
        bqk = self._dev(np.zeros((Q, k_max, s.width + 1), np.uint32))
        idx, found, _ = _resolve_sb_step(s.keys, s.counts, bqk, s.hash_slots,
                                         s.max_probes)
        n += 1
        kv = self._dev(np.zeros(Q, np.int32))
        sel = self._dev(np.arange(Q, dtype=np.int32))
        max_blocks = k_max * (-(-max(1, s.max_count) // 128))
        for SB in self._SB_CLASSES:
            for op in ops:
                concat_step(s.blocks, s.term_block_start, s.counts, idx,
                            found, kv, sel, SB, op)
                n += 1
            if SB >= max_blocks:
                break
        if "and" in ops:
            rems = [None]
            if st.removed is not None and st.removed.shape[0] > 0:
                rems.append(st.removed)
            for rem in rems:
                boolean_fused_step(s.keys, s.blocks, s.term_block_start,
                                   s.counts, bqk, kv, self.L, rem,
                                   s.hash_slots, s.max_probes,
                                   self._FUSED_SMALL_P)
                boolean_fused_staged_step(
                    s.keys, s.blocks, s.term_block_start, s.counts, bqk, kv,
                    self.L, self._staged_levels(st), rem, s.hash_slots,
                    s.max_probes, self._STAGED_SMALL_P)
                n += 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    @staticmethod
    def _tables_bytes(t: Optional[HostTables]) -> int:
        if t is None:
            return 0
        return int(sum(a.nbytes for a in (t.keys, t.words, t.flat, t.tbs,
                                          t.counts, t.removed, t.slots)))

    def stats(self) -> Dict[str, object]:
        """Size counters of the serving state: host_bytes is the per-term
        count vector (always kept), tables_bytes the retained compact
        tables (0 without keep_tables); fused_and says whether the device
        route's AND takes K2 (not in a delta window, whose dual step takes
        K3); host_serving is host_ready()."""
        st = self._state
        s, d = st.snap, st.delta
        return {
            "n_terms": s.n_terms,
            "n_postings": (int(s.host_counts.sum())
                           if s.host_counts is not None else 0),
            "max_posting_len": s.max_count,
            "device_bytes": s.device_bytes(),
            "host_bytes": (int(s.host_counts.nbytes)
                           if s.host_counts is not None else 0),
            "tables_bytes": (self._tables_bytes(st.tables)
                             + self._tables_bytes(st.delta_tables)),
            "delta_terms": 0 if d is None else d.n_terms,
            "delta_device_bytes": 0 if d is None else d.device_bytes(),
            "ladder": self._levels(st),
            "fused_and": d is None,
            "host_serving": st.host_ready(),
        }

    # -- the router ----------------------------------------------------------
    #
    # The host route's mechanics are in models/host_serve.py, the streams
    # in models/staged.py; the policy between them is here, beside the link
    # probe it reads.

    def _host_busy(self) -> bool:
        """The load signal: the host route spends host CPU to save link
        bytes, so a staged stream goes back to the device pipeline while
        the host is busy. First the engine's own index (from_index and
        from_checkpoint wire InvertedIndex.is_busy: True while a put,
        put_removed or merge runs, so the route flips within a batch); then,
        for load the engine cannot see, the 1-minute load average per core
        above TPI_HOST_BUSY_LOAD (default 1.5). TPI_HOST_BUSY_LOAD=0 turns
        both off."""
        thresh = float(os.environ.get("TPI_HOST_BUSY_LOAD", "1.5"))
        if thresh <= 0:
            return False
        fn = self._busy_fn
        if fn is not None and fn():
            return True
        try:
            load = os.getloadavg()[0]
        except OSError:
            return False
        return load / max(1, os.cpu_count() or 1) > thresh

    def _host_boolean_route(self, op: str, prefix_p: int = 0,
                            staged: bool = False,
                            st: Optional[ServingState] = None) -> bool:
        """True when boolean / boolean_staged should serve `op` on the host
        (needs retained tables). In a warm start's upload window every
        shape does. Pages (prefix_p) stay on the device, whose fetch they
        already bound. TPI_HOST_BOOL=or|and|all|0 forces the choice; auto
        (the default) takes the host for full-result OR below
        _HOST_ROUTE_OR_LINK_MBPS and for AND below _HOST_ROUTE_LINK_MBPS of
        the probed link, and keeps a staged stream on the device while the
        host is busy (_host_busy) or when TPI_HYBRID=1 asks for the hybrid
        stream (_hybrid_staged)."""
        st = st if st is not None else self._state
        if not st.device_ready and st.host_ready():
            return True
        if prefix_p or not st.host_ready():
            return False
        mode = os.environ.get("TPI_HOST_BOOL", "auto")
        if mode != "auto":
            return mode == "all" or mode == op
        if op == "or":
            if staged and self._host_busy():
                return False
            return _link_mbps(self.device) < self._HOST_ROUTE_OR_LINK_MBPS
        if staged and (os.environ.get("TPI_HYBRID") == "1"
                       or self._host_busy()):
            return False
        return _link_mbps(self.device) < self._HOST_ROUTE_LINK_MBPS

    def _hybrid_staged(self, op: str,
                       st: Optional[ServingState] = None) -> bool:
        """The staged AND stream's hybrid mode, asked for by TPI_HYBRID=1
        (with TPI_HOST_BOOL unset or auto, retained tables, no delta, and
        the link below _HOST_ROUTE_LINK_MBPS): the device pipeline claims
        batches from the head while a host thread serves from the tail
        through the native serve, so the two rates add."""
        st = st if st is not None else self._state
        if op != "and" or not st.host_ready() or st.delta is not None:
            return False
        if os.environ.get("TPI_HYBRID") != "1":
            return False
        if os.environ.get("TPI_HOST_BOOL", "auto") != "auto":
            return False
        return _link_mbps(self.device) < self._HOST_ROUTE_LINK_MBPS

    # -- exact lookup ------------------------------------------------------

    def _lookup_on(self, s: IndexSnapshot, qkeys: torch.Tensor, removed,
                   L: Optional[int] = None):
        return lookup_step(
            s.keys, s.blocks, s.term_block_start, s.counts, qkeys,
            L or self.L, s.hash_slots, s.max_probes, removed)

    def lookup_device(self, qkeys: torch.Tensor, filter_removed: bool = False,
                      L: Optional[int] = None):
        """The raw lookup step over the main snapshot: qkeys (Q, W+1) packed
        term keys as int32 bits on the engine's device
        (keys_mod.pack_terms, then utils.u32.to_device). Returns (found,
        postings (Q, L), counts, raw counts) as tensors; a raw count above L
        means the row is clipped. The delta tier is lookup()'s concern."""
        st = self._serving_state()
        return self._lookup_on(st.snap, qkeys,
                               st.removed if filter_removed else None, L)

    def lookup(self, terms: Sequence[bytes],
               filter_removed: bool = False) -> List[Optional[np.ndarray]]:
        """Exact postings per term (None for misses). filter_removed drops
        tombstoned values. Lists longer than L are re-served at a ladder
        level, so results are always exact. With a delta live, a term's
        result is the union of its rows in both tiers. In a warm start's
        upload window it reads the retained tables (lookup_host)."""
        if not terms:
            return []
        st = self._serving_state()
        if not st.device_ready and st.host_ready():
            return self.lookup_host(terms, filter_removed)  # warm window
        main = self._exact_rows(st, st.snap, terms, filter_removed)
        if st.delta is None:
            return main
        dl = self._exact_rows(st, st.delta, terms, filter_removed)
        return [b if a is None else a if b is None else np.union1d(a, b)
                for a, b in zip(main, dl)]

    def _exact_rows(self, st: ServingState, s: IndexSnapshot,
                    terms: Sequence[bytes],
                    filter_removed: bool) -> List[Optional[np.ndarray]]:
        if s.n_terms == 0:
            return [None] * len(terms)
        removed = st.removed if filter_removed else None
        qk = keys_mod.pack_terms(list(terms), width=s.width)
        found, vals, n, raw = self._lookup_on(s, self._dev(qk), removed)
        found = found.cpu().numpy()
        n = n.cpu().numpy()
        raw = raw.cpu().numpy()
        vals = to_numpy_u32(vals)
        out: List[Optional[np.ndarray]] = [None] * len(terms)
        long_idx = []
        for i in range(len(terms)):
            if not found[i]:
                continue
            if raw[i] > self.L:
                long_idx.append(i)
            else:
                out[i] = vals[i, : n[i]].copy()
        # largest need first: each batch re-serves at ITS level
        long_idx.sort(key=lambda i: -raw[i])
        while long_idx:
            lv = self._level_for(int(max(raw[i] for i in long_idx)), st)
            qb = max(1, _RESERVE_BUDGET // lv)
            batch, long_idx = long_idx[:qb], long_idx[qb:]
            _, v2, n2, _ = self._lookup_on(s, self._dev(qk[batch]), removed,
                                           L=lv)
            n2 = n2.cpu().numpy()
            v2 = to_numpy_u32(v2[:, : max(1, int(n2.max(initial=0)))])
            for j, i in enumerate(batch):
                out[i] = v2[j, : n2[j]].copy()
        return out

    # -- boolean AND -------------------------------------------------------

    def _pack_boolean(self, st: ServingState, queries):
        """Query batch -> (qk (Q, K, W+1) uint32, kv (Q,) int32) at the
        state's query width."""
        return _pack_queries(queries, st.width())

    def _pack_boolean_cols(self, st: ServingState, blob, offsets, qoffs):
        """Columnar batch (blob, offsets[T+1], qoffs[Q+1]) -> (qk, kv)."""
        W = st.width()
        offsets = np.asarray(offsets, dtype=np.int64)
        qoffs = np.asarray(qoffs, dtype=np.int64)
        nq = len(qoffs) - 1
        kvq = np.diff(qoffs)
        K = max(1, int(kvq.max(initial=1)))
        qk = np.zeros((nq, K, W + 1), dtype=np.uint32)
        kv = kvq.astype(np.int32)
        blob8 = (np.frombuffer(blob, dtype=np.uint8)
                 if isinstance(blob, (bytes, bytearray))
                 else np.asarray(blob, dtype=np.uint8))
        packed = keys_mod.pack_blob(blob8, offsets, W)
        rows = np.repeat(np.arange(nq), kvq)
        cols = np.arange(qoffs[-1], dtype=np.int64) - np.repeat(qoffs[:-1], kvq)
        qk[rows, cols] = packed
        return qk, kv

    def _batch_pack(self, st: ServingState, queries):
        """One stream batch (term lists or a columnar triple) -> (nq, qk,
        kv)."""
        if isinstance(queries, tuple) and len(queries) == 3:
            nq = len(queries[2]) - 1
            if nq <= 0:
                return 0, None, None
            qk, kv = self._pack_boolean_cols(st, *queries)
            return nq, qk, kv
        if not queries:
            return 0, None, None
        qk, kv = self._pack_boolean(st, queries)
        return len(queries), qk, kv

    def boolean(self, queries: Sequence[Sequence[bytes]], op: str,
                filter_removed: bool = False):
        """Batch of AND/OR queries of 1..K terms -> sorted unique arrays. A
        missing term empties an AND query and adds nothing to an OR query.
        Exact at any list length. The router (_host_boolean_route) may serve
        the batch on the host (boolean_host), with the same results."""
        if op not in ("and", "or"):
            raise ValueError(f"op {op!r}: want 'and' or 'or'")
        if not queries:
            return []
        st = self._serving_state()
        if self._host_boolean_route(op, st=st):
            return self.boolean_host(queries, op, filter_removed, _st=st)
        if len(queries) >= self._STAGED_DELEGATE_MIN and st.snap.n_terms > 0:
            return self.boolean_staged(
                [queries], op, filter_removed, _st=st)[0]
        if st.snap.n_terms == 0 and st.delta is None:
            return [np.zeros(0, np.uint32) for _ in queries]
        qk, kv = self._pack_boolean(st, queries)
        removed = st.removed if filter_removed else None
        if st.delta is None:
            if op == "and":
                return self._boolean_fused(st, queries, qk, kv, removed)
            return self._boolean_concat(st, queries, qk, kv, op, removed)[0]
        # delta window: the padded dual step at L, then ladder re-serves of
        # the rows whose tiers' summed count exceeds L (the JAX engine's
        # _reserve_ladder: the same batching rule as _drain_levels)
        run = self._dual_run(st, op, removed)
        out, oc, need = run(self.L, qk, kv)
        oc = oc.cpu().numpy()
        need = need.cpu().numpy()
        out = to_numpy_u32(out[:, : max(1, int(oc.max(initial=0)))])
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        longs = []
        for i in range(len(queries)):
            if need[i] <= self.L:
                results[i] = out[i, : oc[i]].copy()
            else:
                longs.append((i, qk[i], int(kv[i]),
                              self._level_for(int(need[i]), st)))
        self._drain_levels(longs, run, results.__setitem__)
        return results

    def _dual_run(self, st: ServingState, op: str, removed):
        """run(lv, qk, kv) -> (out, oc, need): one pass of the padded dual
        step at pad lv over the state's main and delta tiers. Queries are
        packed at st.width() and narrowed to each tier's width."""
        s, d = st.snap, st.delta

        def run(lv, qk_sub, kv_sub):
            return boolean_step_dual(
                s.keys, s.blocks, s.term_block_start, s.counts, s.hash_slots,
                d.keys, d.blocks, d.term_block_start, d.counts, d.hash_slots,
                self._dev(_narrow_keys(qk_sub, s.width)),
                self._dev(_narrow_keys(qk_sub, d.width)),
                self._dev(kv_sub), lv, op, removed, s.max_probes,
                d.max_probes)
        return run

    def _fused_run(self, st, lv, qk_sub, kv_sub, removed, small_p: int = 0):
        s = st.snap
        return boolean_fused_step(
            s.keys, s.blocks, s.term_block_start, s.counts,
            self._dev(_narrow_keys(qk_sub, s.width)), self._dev(kv_sub), lv,
            removed, s.hash_slots, s.max_probes, small_p)

    def _staged_levels(self, st: ServingState) -> torch.Tensor:
        """Ascending ladder levels K2 serves (<= MAX_LEVEL), on the device;
        cached per ladder."""
        lvls = tuple(lv for lv in self._levels(st) if lv <= MAX_LEVEL)
        cached = self._staged_levels_cache
        if cached is None or cached[0] != lvls:
            arr = torch.tensor(lvls or (self.L,), dtype=torch.int64,
                               device=self.device)
            cached = (lvls, arr)
            self._staged_levels_cache = cached
        return cached[1]

    def _fused_run_staged(self, st, qk_sub, kv_sub, removed):
        s = st.snap
        return boolean_fused_staged_step(
            s.keys, s.blocks, s.term_block_start, s.counts,
            self._dev(_narrow_keys(qk_sub, s.width)), self._dev(kv_sub),
            self.L, self._staged_levels(st), removed, s.hash_slots,
            s.max_probes, self._STAGED_SMALL_P)

    def _dedup_batch(self, nq: int, qk, kv, row_cost_us: float = None):
        """Cross-query dedup for a staged batch: group identical packed
        rows on the host, serve each distinct query once, and fan results
        out through `inv` at assembly. Returns (nu, qk_u, kv_u, inv), inv
        None when dedup does not pay (fewer than 64 queries,
        TPI_STAGED_DEDUP=0, or too few duplicates to shrink the batch by a
        grid step of batch/16 rows; TPI_STAGED_DEDUP=force skips the cost
        gate, never the shrink check). row_cost_us replaces the fused AND's
        per-row cost (L x 0.003 us) for the concat stream's rows."""
        mode = os.environ.get("TPI_STAGED_DEDUP", "1")
        if nq < 64 or mode == "0":
            return nq, qk, kv, None
        comb = np.concatenate(
            [qk.reshape(nq, -1).astype(np.int64),
             kv.astype(np.int64).reshape(nq, 1)], axis=1)
        # 64-bit row hash: collisions only merge candidate groups, which
        # the full-row verify below splits again exactly
        h = comb @ self._dedup_mults(comb.shape[1])
        grid = max(8, _round_up(nq, 8) // 16)
        target = _round_up(len(np.unique(h)), grid)
        if target >= _round_up(nq, grid):
            return nq, qk, kv, None
        saved_rows = _round_up(nq, grid) - target
        # cost gate: the JAX engine's constants (saved rows x L x 0.003,
        # or row_cost_us, against 4000), carried over unmeasured on the
        # card (PERF.md)
        rc = row_cost_us if row_cost_us is not None else self.L * 0.003
        if mode != "force" and saved_rows * rc < 2 * 2000.0:
            return nq, qk, kv, None
        order = np.argsort(h, kind="stable")
        sc = comb[order]
        neq = np.empty(nq, dtype=bool)
        neq[0] = True
        np.any(sc[1:] != sc[:-1], axis=1, out=neq[1:])
        first = order[neq]
        inv = np.empty(nq, dtype=np.int32)
        inv[order] = (np.cumsum(neq) - 1).astype(np.int32)
        nu = len(first)
        target = _round_up(nu, grid)
        qk_u = np.zeros((target,) + qk.shape[1:], dtype=qk.dtype)
        kv_u = np.zeros(target, dtype=kv.dtype)
        qk_u[:nu] = qk[first]
        kv_u[:nu] = kv[first]
        return nu, qk_u, kv_u, inv

    @staticmethod
    def _dedup_mults(n: int) -> np.ndarray:
        """Fixed odd multipliers for the dedup row hash."""
        return np.array(
            [(0x9E3779B97F4A7C15 - (i * 2 + 1) * 0x61C8864680B583EB)
             & 0xFFFFFFFFFFFFFFFF for i in range(max(n, 64))],
            dtype=np.uint64,
        ).astype(np.int64)[:n]

    def _classify_fused(self, st, fetched, positions, qk, kv, setter,
                        wide, longs, overs):
        """Assign direct results from a small-P fetch; defer the rare
        classes: small-P overflow (sort path), base count over L (ladder
        re-serve), ladder level over MAX_LEVEL (concat AND)."""
        small, oc, need, oc_pre = fetched
        P = self._FUSED_SMALL_P
        for j, pos in enumerate(positions):
            if need[j] <= self.L and oc_pre[j] <= P:
                setter(pos, small[j, : oc[j]].copy())
            elif need[j] <= self.L:
                wide.append((pos, qk[j], int(kv[j])))
            elif self._level_for(int(need[j]), st) <= MAX_LEVEL:
                longs.append((pos, qk[j], int(kv[j]), int(need[j])))
            else:
                overs.append((pos, qk[j], int(kv[j])))

    def _drain_levels(self, items, run, setter):
        """Exact re-serve drain. items: (pos, qk_row (K_i, W+1), kv, lv),
        served in batches at the level of their largest member (exact for
        every smaller one). All dispatches are issued before any fetch;
        in-flight results are capped at 4x the reserve budget."""
        dispatches = []  # (members, out, cnt)
        pend = 0

        def drain():
            nonlocal pend
            with tracing.span("tpi.harvest"):
                with tracing.span("tpi.wait"):
                    counts = [d[2].cpu().numpy() for d in dispatches]
                for (members, o, _), c in zip(dispatches, counts):
                    with tracing.span("tpi.wait"):
                        o = to_numpy_u32(
                            o[:, : max(1, int(c.max(initial=0)))])
                    for j, t in enumerate(members):
                        setter(t[0], o[j, : c[j]].copy())
            dispatches.clear()
            pend = 0

        items.sort(key=lambda t: -t[3])
        i = 0
        while i < len(items):
            lv = int(items[i][3])
            K = max(t[1].shape[0] for t in items)
            qb = max(1, _RESERVE_BUDGET // (K * lv))
            batch = items[i: i + qb]
            i += len(batch)
            bq = self._stack_rows([t[1] for t in batch])
            bkv = np.array([t[2] for t in batch], dtype=np.int32)
            with tracing.span("tpi.dispatch"):
                o2, c2, _ = run(lv, bq, bkv)
            dispatches.append((batch, o2, c2))
            pend += len(batch) * lv * 4
            if pend > 4 * _RESERVE_BUDGET:
                drain()
        if dispatches:
            drain()

    @staticmethod
    def _stack_rows(rows):
        """Stack per-query (K_b, W+1) key rows into (B, Kmax, W+1)."""
        Kmax = max(r.shape[0] for r in rows)
        bq = np.zeros((len(rows), Kmax, rows[0].shape[1]), dtype=np.uint32)
        for j, r in enumerate(rows):
            bq[j, : r.shape[0]] = r
        return bq

    def _fused_followups(self, st, setter, wide, longs, overs, removed):
        """Serve the deferred classes once per call (shared by boolean()
        and the staged stream). Returns (the number of concat ANDs served
        singly past the largest class, the concat steps launched)."""
        with tracing.span("tpi.followups"):
            items = [(t[0], t[1], t[2], self.L) for t in wide]
            items += [(t[0], t[1], t[2], self._level_for(int(t[3]), st))
                      for t in longs]
            self._drain_levels(
                items,
                lambda lv, q, k2: self._fused_run(st, lv, q, k2, removed),
                setter)
            if not overs:
                return 0, 0
            bq = self._stack_rows([t[1] for t in overs])
            bkv = np.array([t[2] for t in overs], dtype=np.int32)
            res, singles, chunks = self._boolean_concat(
                st, [None] * len(overs), bq, bkv, "and", removed)
            for t, v in zip(overs, res):
                setter(t[0], v)
            return singles, chunks

    def _boolean_fused(self, st, queries, qk, kv, removed):
        """AND through K2: one pass + one fetch for the common case;
        ladder re-serves keyed on the base (smallest-list) count."""
        small, oc, need, oc_pre = self._fused_run(
            st, self.L, qk, kv, removed, small_p=self._FUSED_SMALL_P)
        fetched = (to_numpy_u32(small), oc.cpu().numpy(),
                   need.cpu().numpy(), oc_pre.cpu().numpy())
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        wide, longs, overs = [], [], []

        def setter(i, v):
            results[i] = v

        self._classify_fused(st, fetched, range(len(queries)), qk, kv,
                             setter, wide, longs, overs)
        self._fused_followups(st, setter, wide, longs, overs, removed)
        return results

    # -- range and prefix reads -------------------------------------------

    def read_range(self, min_term: Optional[bytes] = None,
                   max_term: Optional[bytes] = None):
        """Sorted (term, values) stream over [min_term, max_term], both
        inclusive, None open: InvertedIndex.read() on the frozen state. In
        a delta window the two tiers merge by term, values united on a tie.
        With retained tables it reads them on the host (a range read is
        pure output); otherwise the range is found by two searches of the
        device key rows and the postings decode through K1,
        _RANGE_CHUNK terms at a time."""
        st = self._serving_state()
        host = st.host_ready()
        main = (self._read_range_on_tables(st.tables, min_term, max_term)
                if host else self._read_range_on(st, st.snap, min_term,
                                                 max_term))
        if st.delta is None:
            yield from main
            return
        dl = (self._read_range_on_tables(st.delta_tables, min_term, max_term)
              if host else self._read_range_on(st, st.delta, min_term,
                                               max_term))
        a = next(main, None)
        b = next(dl, None)
        while a is not None or b is not None:
            if b is None or (a is not None and a[0] < b[0]):
                yield a
                a = next(main, None)
            elif a is None or b[0] < a[0]:
                yield b
                b = next(dl, None)
            else:
                yield a[0], np.union1d(a[1], b[1])
                a = next(main, None)
                b = next(dl, None)

    def _read_range_on(self, st, s: IndexSnapshot, min_term, max_term):
        if s.n_terms == 0:
            return
        lo = 0 if min_term is None else int(searchsorted_rows(
            s.keys,
            self._dev(keys_mod.pack_terms([min_term], width=s.width)))[0])
        hi = s.n_terms if max_term is None else int(searchsorted_rows(
            s.keys, self._dev(keys_mod.pack_terms([max_term], width=s.width)),
            side="right")[0])
        for c0 in range(lo, hi, self._RANGE_CHUNK):
            c1 = min(c0 + self._RANGE_CHUNK, hi)
            blob, offs = keys_mod.unpack_keys(to_numpy_u32(s.keys[c0:c1]))
            vals, voffs = self._decode_indices(np.arange(c0, c1), s, st)
            for j in range(c1 - c0):
                yield (blob[offs[j]: offs[j + 1]].tobytes(),
                       vals[voffs[j]: voffs[j + 1]])

    def _read_range_on_tables(self, t: HostTables, min_term, max_term):
        if t.n_terms == 0:
            return
        lo = 0 if min_term is None else int(keys_mod.searchsorted_rows(
            t.keys, keys_mod.pack_terms([min_term], width=t.width))[0])
        hi = t.n_terms if max_term is None else int(
            keys_mod.searchsorted_rows(
                t.keys, keys_mod.pack_terms([max_term], width=t.width),
                side="right")[0])
        for c0 in range(lo, hi, self._RANGE_CHUNK):
            c1 = min(c0 + self._RANGE_CHUNK, hi)
            blob, offs = keys_mod.unpack_keys(t.keys[c0:c1])
            vals, voffs = self._host_decode(t, np.arange(c0, c1))
            for j in range(c1 - c0):
                yield (blob[offs[j]: offs[j + 1]].tobytes(),
                       vals[voffs[j]: voffs[j + 1]])

    def prefix_search(self, prefixes: Sequence[bytes]
                      ) -> Dict[bytes, np.ndarray]:
        """InvertedIndex.prefix_search on the frozen state: each prefix
        that some term holds -> the sorted union of those terms' values;
        prefixes nothing holds are absent. In a delta window both tiers
        unite. With retained tables it reads them on the host; otherwise
        the ranges come from prefix_range_step on the device and the
        postings decode through K1."""
        st = self._serving_state()
        if st.host_ready():
            out = self._prefix_on_tables(st.tables, prefixes)
            more = (self._prefix_on_tables(st.delta_tables, prefixes)
                    if st.delta is not None else {})
        else:
            out = self._prefix_on(st, st.snap, prefixes)
            more = (self._prefix_on(st, st.delta, prefixes)
                    if st.delta is not None else {})
        for p, v in more.items():
            out[p] = np.union1d(out[p], v) if p in out else v
        return out

    @staticmethod
    def _prefix_spans(prefixes, lo, hi):
        """[(prefix, lo, hi)] of the prefixes with a non-empty range, and
        every term index of those ranges."""
        spans = [(p, int(lo[i]), int(hi[i])) for i, p in enumerate(prefixes)
                 if hi[i] > lo[i]]
        idx = (np.concatenate([np.arange(a, b) for _, a, b in spans])
               if spans else np.zeros(0, np.int64))
        return spans, idx

    @staticmethod
    def _prefix_unions(spans, vals, voffs) -> Dict[bytes, np.ndarray]:
        out: Dict[bytes, np.ndarray] = {}
        k0 = 0
        for p, a, b in spans:
            k1 = k0 + (b - a)
            # sorted unique by a sort and a compare of neighbours: numpy's
            # unique hashes from 2.3 on, many times slower on such unions
            out[p] = _dedup_adjacent(np.sort(vals[voffs[k0]: voffs[k1]]))
            k0 = k1
        return out

    def _prefix_on_tables(self, t: HostTables,
                          prefixes) -> Dict[bytes, np.ndarray]:
        if t.n_terms == 0 or not prefixes:
            return {}
        lo_k, hi_k = keys_mod.prefix_bounds(list(prefixes), t.width)
        spans, idx = self._prefix_spans(
            prefixes, keys_mod.searchsorted_rows(t.keys, lo_k),
            keys_mod.searchsorted_rows(t.keys, hi_k))
        if not spans:
            return {}
        return self._prefix_unions(spans, *self._host_decode(t, idx))

    def _prefix_on(self, st, s: IndexSnapshot,
                   prefixes) -> Dict[bytes, np.ndarray]:
        if s.n_terms == 0 or not prefixes:
            return {}
        lo_k, hi_k = keys_mod.prefix_bounds(list(prefixes), s.width)
        lo, hi = prefix_range_step(s.keys, self._dev(lo_k), self._dev(hi_k))
        spans, idx = self._prefix_spans(prefixes, lo.cpu().numpy(),
                                        hi.cpu().numpy())
        if not spans:
            return {}
        return self._prefix_unions(spans,
                                   *self._decode_indices(idx, s, st))
