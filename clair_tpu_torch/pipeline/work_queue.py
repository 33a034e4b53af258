"""Shared-filesystem work queue for multi-host WGS fan-out.

The reference scales across machines by hand-splitting the GNU-parallel
command sheet (reference README.md:322 — "you can split the
command.sh into multiple parts"); slow hosts then straggle because the
split is static. `--num_shards/--shard_id` reproduces that static model;
this queue replaces it with dynamic claiming: every host runs the same
command pointed at one shared directory, windows are claimed atomically
(O_CREAT|O_EXCL), and fast hosts simply take more windows. No server, no
network protocol — the shared filesystem IS the coordinator, matching the
share-nothing window model (SURVEY §2 "parallelism strategies").

Layout under the queue directory:

    manifest.json            the window list + calling parameters (written
                             once, atomically, by whichever host runs first)
    claims/<window>.claim    one JSON line {host, pid, time}; existence =
                             claimed; mtime refreshed as a heartbeat
    done/<window>.json       {status, sites, elapsed, host}; existence =
                             finished (ok or failed)
    vcf/<window>.vcf         per-window output rows (headerless)

A crashed host leaves a claim with a stale mtime and no done record;
`reclaim_stale_s` lets other hosts delete such claims and take the window
over. `finalize` concatenates finished windows in genome order into one
VCF and reports any failed/missing windows.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import threading
import time
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

Window = Tuple[str, int, int]


def _window_key(window: Window) -> str:
    return f"{window[0]}_{window[1]}_{window[2]}"


class WorkQueue:
    def __init__(self, root: str):
        self.root = root
        self._scan_from = 0  # done-prefix skip for next_window (see below)
        self.claims = os.path.join(root, "claims")
        self.done = os.path.join(root, "done")
        self.vcf = os.path.join(root, "vcf")
        self.manifest_path = os.path.join(root, "manifest.json")

    # -- setup ------------------------------------------------------------

    def initialize(self, windows: List[Window], meta: Optional[dict] = None) -> bool:
        """Write the manifest if absent. Atomic: the first host wins, the
        rest see the existing manifest. Returns True when this call did
        the initialization."""
        for sub in (self.claims, self.done, self.vcf):
            os.makedirs(sub, exist_ok=True)
        payload = json.dumps(
            {"windows": [list(w) for w in windows], "meta": meta or {}}
        )
        tmp = self.manifest_path + f".tmp.{socket.gethostname()}.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(payload)
        try:
            # link(2) fails with EEXIST if another host already initialized
            os.link(tmp, self.manifest_path)
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def windows(self) -> List[Window]:
        with open(self.manifest_path) as fh:
            manifest = json.load(fh)
        return [(w[0], int(w[1]), int(w[2])) for w in manifest["windows"]]

    def meta(self) -> dict:
        with open(self.manifest_path) as fh:
            return json.load(fh).get("meta", {})

    # -- claiming ---------------------------------------------------------

    def _claim_path(self, window: Window) -> str:
        return os.path.join(self.claims, _window_key(window) + ".claim")

    def _done_path(self, window: Window) -> str:
        return os.path.join(self.done, _window_key(window) + ".json")

    def vcf_path(self, window: Window) -> str:
        return os.path.join(self.vcf, _window_key(window) + ".vcf")

    def try_claim(self, window: Window) -> bool:
        try:
            fd = os.open(self._claim_path(window), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as fh:
            fh.write(json.dumps(
                {"host": socket.gethostname(), "pid": os.getpid(), "time": time.time()}
            ))
        return True

    def heartbeat(self, window: Window) -> None:
        try:
            os.utime(self._claim_path(window))
        except OSError:
            pass

    def reclaim_stale(self, stale_s: float) -> int:
        """Delete claims older than stale_s with no done record, freeing
        their windows for other hosts. Returns the count freed."""
        freed = 0
        now = time.time()
        try:
            names = os.listdir(self.claims)
        except OSError:
            return 0
        for name in names:
            if not name.endswith(".claim"):
                continue
            path = os.path.join(self.claims, name)
            done = os.path.join(self.done, name[: -len(".claim")] + ".json")
            try:
                if os.path.isfile(done):
                    continue
                if now - os.path.getmtime(path) > stale_s:
                    os.unlink(path)
                    freed += 1
                    logger.warning("reclaimed stale window claim %s", name)
            except OSError:
                continue  # another host raced us; fine either way
        return freed

    def next_window(self) -> Optional[Window]:
        """Claim and return an unstarted window (None when none remain
        unclaimed — finished or not).

        Scanning restarts after the longest done-prefix instead of from
        zero: with fine chunking a WGS queue holds thousands of windows,
        and a full rescan per claim would cost O(W^2) stat calls. Windows
        before the prefix can never need work again (done records are
        permanent); claimed-but-unfinished windows halt the prefix so
        reclaimed windows are still found."""
        windows = self.windows()
        advancing = True
        for idx in range(self._scan_from, len(windows)):
            window = windows[idx]
            if os.path.isfile(self._done_path(window)):
                if advancing and idx == self._scan_from:
                    self._scan_from = idx + 1
                continue
            advancing = False
            if os.path.isfile(self._claim_path(window)):
                continue
            if self.try_claim(window):
                return window
        return None

    # -- completion -------------------------------------------------------

    def mark_done(self, window: Window, status: str, sites: int = 0,
                  error: Optional[str] = None, elapsed: float = 0.0) -> None:
        payload = {
            "status": status, "sites": sites, "elapsed": round(elapsed, 3),
            "host": socket.gethostname(),
        }
        if error is not None:
            payload["error"] = error
        tmp = self._done_path(window) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(payload))
        os.replace(tmp, self._done_path(window))

    def status(self) -> dict:
        windows = self.windows()
        done_ok, done_failed, claimed = 0, 0, 0
        for window in windows:
            if os.path.isfile(self._done_path(window)):
                with open(self._done_path(window)) as fh:
                    entry = json.load(fh)
                if entry.get("status") == "ok":
                    done_ok += 1
                else:
                    done_failed += 1
            elif os.path.isfile(self._claim_path(window)):
                claimed += 1
        return {
            "total": len(windows), "ok": done_ok, "failed": done_failed,
            "in_progress": claimed,
            "unclaimed": len(windows) - done_ok - done_failed - claimed,
        }


def run_worker(
    queue: WorkQueue,
    base_config,
    predictor,
    reclaim_stale_s: Optional[float] = None,
    poll_s: float = 5.0,
    wait_for_stragglers: bool = False,
) -> int:
    """Claim windows until the queue is drained; returns sites called by
    THIS worker. Each window's rows go to the queue's vcf/ directory
    (headerless; `finalize` assembles the merged VCF).

    With wait_for_stragglers the worker idles (polling, reclaiming stale
    claims when enabled) until every window has a done record — useful so
    the last host standing can take over windows from crashed peers."""
    from clair_tpu_torch.io.vcf import VcfWriter
    from clair_tpu_torch.pipeline.call_bam import call_window, prepare_window

    total = 0
    while True:
        if reclaim_stale_s is not None:
            queue.reclaim_stale(reclaim_stale_s)
        window = queue.next_window()
        if window is None:
            if not wait_for_stragglers:
                return total
            state = queue.status()
            if state["ok"] + state["failed"] == state["total"]:
                return total
            time.sleep(poll_s)
            continue
        contig, start, end = window
        config = dataclasses.replace(
            base_config, contig=contig, ctg_start=start, ctg_end=end
        )
        started = time.perf_counter()
        # refresh the claim mtime for as long as the window runs — without
        # this a slow (but healthy) window older than reclaim_stale_s
        # would be taken over by a peer and computed twice
        stop_beat = threading.Event()
        beat_every = max((reclaim_stale_s or 120.0) / 4.0, 1.0)

        def _beat():
            while not stop_beat.wait(beat_every):
                queue.heartbeat(window)

        beater = threading.Thread(target=_beat, daemon=True)
        beater.start()
        try:
            work = prepare_window(config)
            path = queue.vcf_path(window)
            with open(path + f".tmp.{os.getpid()}", "w") as fh:
                from clair_tpu_torch.io.vcf import make_writer

                writer = make_writer(base_config, fh)
                sites = call_window(work, predictor, writer)
            os.replace(path + f".tmp.{os.getpid()}", path)
            queue.mark_done(window, "ok", sites=sites,
                            elapsed=time.perf_counter() - started)
            logger.info("window %s:%d-%d -> %d sites", contig, start, end, sites)
            total += sites
        except Exception as exc:
            queue.mark_done(window, "failed", error=f"{type(exc).__name__}: {exc}",
                            elapsed=time.perf_counter() - started)
            logger.error("window %s:%d-%d FAILED: %s", contig, start, end, exc)
        finally:
            stop_beat.set()
            beater.join()
    return total


def finalize(queue: WorkQueue, output_path: str, sample_name: str = "SAMPLE",
             contigs=None, qual=None, gvcf: bool = False) -> dict:
    """Merge finished windows (genome order) into one VCF with a header.
    Returns the queue status; failed/missing windows are reported, their
    rows absent (re-run workers after reclaiming to fill them)."""
    from clair_tpu_torch.io.vcf import VcfWriter

    state = queue.status()
    # temp + atomic rename: several hosts can reach completion near-
    # simultaneously and all finalize the same shared path
    tmp_path = output_path + f".tmp.{socket.gethostname()}.{os.getpid()}"
    if output_path.endswith(".gz"):
        from clair_tpu_torch.io.tbi import BgzfTextWriter

        out = BgzfTextWriter(tmp_path)
    else:
        out = open(tmp_path, "w")
    with out:
        writer = VcfWriter(out, sample_name=sample_name, contigs=contigs,
                           quality_score_for_pass=qual)
        if gvcf:
            from clair_tpu_torch.pipeline.gvcf import GVCF_HEADER_EXTRA

            writer.header_extra = GVCF_HEADER_EXTRA
        writer.write_header()
        for window in queue.windows():
            path = queue.vcf_path(window)
            if os.path.isfile(path):
                with open(path) as fh:
                    for line in fh:
                        if not line.startswith("#"):
                            out.write(line)
    os.replace(tmp_path, output_path)
    if output_path.endswith(".gz"):
        # build_tbi writes via its own temp + atomic replace, so racing
        # finalizers produce identical complete indexes
        from clair_tpu_torch.io.tbi import build_tbi

        build_tbi(output_path)
    if state["failed"] or state["unclaimed"] or state["in_progress"]:
        logger.warning(
            "finalize with incomplete queue: %s (failed/unfinished windows "
            "are missing from %s)", state, output_path,
        )
    return state
