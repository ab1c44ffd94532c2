"""Erasure-coded sharded checkpoints with BMFRepair/MSRepair recovery.

Layout on disk, the JAX package's byte for byte (`treedef` excepted):
  <dir>/step_<N>/manifest.json          treedef, shapes, dtypes, code, placement
  <dir>/step_<N>/domain_<d>.bin         every block placed on failure domain d

The train state is a nested dict of tensors; its leaves, walked with the
keys sorted at every level (`jax.tree.flatten`'s order for dicts), are
concatenated as raw bytes into one blob. The blob is split into stripes
of k chunk-sized data blocks, and the n-k parity blocks of every stripe
come from one `gf256_matmul_bytes` launch over all stripes at once. Blocks
are placed RAID-5-rotated across `num_domains` failure domains.

`save` snapshots the state's bytes on the checkpointer's device before it
returns: one concatenation of the leaves, so neither an in-place update
nor the next train step reaches a save still running on the background
thread. The thread lays the stripes out, encodes them, copies the blocks
to the host once and writes the domain files; commits are atomic via a
directory rename. A state on a mesh (DTensor leaves) is saved by its
leaves' whole values, so its files are those of the same values held as
plain tensors; `load` returns plain tensors on the template's devices,
which `ft.elastic.reshard_state` places on a (new) mesh.

Losing up to n-k domains is repaired in place: a corrupt or missing
domain file counts as lost, each surviving data block goes from the host
to its row of the restored blob on the device and each parity block a
repair reads to a spare row beside it, the lost data blocks of every
stripe are reconstructed there by one `rs_reconstruct_stripes` launch
straight into the blob, and the repair of the first such stripe is
priced by the configured planner under the cluster's bandwidth process
(msrepair+bmf by default, the paper's algorithms). The reference repairs
stripe by stripe with the same rules and gets the same bytes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.simulator import RepairSimulator, Scenario, SimResult
from repro_torch.device import resolve_device
from repro_torch.ec import stripe as stripe_lib
from repro_torch.ec.rs import RSCode
from repro_torch.kernels import ops

# the manifest's dtype names are the JAX package's (numpy's) names
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
               torch.float16: "float16", torch.float64: "float64",
               torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
               torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class ECCheckpointConfig:
    directory: str
    n: int = 6
    k: int = 4
    chunk_bytes: int = 1 << 20          # 1 MiB blocks
    num_domains: int = 8
    scheme: str = "msrepair"            # repair planner for multi-failure
    single_scheme: str = "bmf"          # repair planner for single failure
    async_save: bool = True


@dataclasses.dataclass
class RepairReport:
    lost_domains: tuple[int, ...]
    stripes_repaired: int
    blocks_repaired: int
    sim: SimResult | None
    wall_seconds: float


def _block_order(stripes) -> dict[int, list[tuple[int, int]]]:
    """Each domain's (stripe, block) entries in file order."""
    per_domain: dict[int, list[tuple[int, int]]] = {}
    for s in stripes:
        for b, node in enumerate(s.node_ids):
            per_domain.setdefault(node, []).append((s.stripe_id, b))
    return per_domain


# the restored blob's device allocations ("windows"): whole rows, at
# most this many bytes each, each freed once the leaves are copied out of
# it, so a load holds about one state besides the template's
WINDOW_BYTES = 64 << 20


@dataclasses.dataclass
class StripeRepair:
    """A load's repair, planned on the host. Its byte space is the
    restored blob (stripe-major data rows: block b of the r-th stripe at
    row r k + b), then the spare rows, one a parity helper (`spare`, their
    (stripe, block)s in order). For each stripe that lost a data block (in
    stripe order): its pattern into `coeffs` (the (f, k) repair
    coefficients of each (lost data blocks, helpers) pair), its helpers'
    byte offsets (S, k) and its lost data blocks' (S, n-k; -1 past its
    f)."""
    coeffs: list
    patterns: np.ndarray
    src_off: np.ndarray
    dst_off: np.ndarray
    spare: list
    blocks: int                          # data blocks repaired
    first_lost: list | None              # the first such stripe's lost blocks


def plan_repair(code: RSCode, stripes, alive: set, cb: int) -> StripeRepair:
    """The reference's per-stripe rules for a load whose surviving
    (stripe, block)s are `alive`: a stripe that lost a data block is
    repaired from its first k surviving blocks; the first that lost more
    than n-k raises the reference's error. A data helper is read in its
    blob row, a parity helper in the next spare row."""
    blob = len(stripes) * code.k * cb
    pattern_of, coeffs, patterns, src_off, dst_off = {}, [], [], [], []
    spare, blocks, first_lost = [], 0, None
    for row, s in enumerate(stripes):
        sid = s.stripe_id
        lost_blocks = [b for b in range(code.n) if (sid, b) not in alive]
        lost_data = [b for b in lost_blocks if b < code.k]
        if not lost_data:
            continue
        if len(lost_blocks) > code.m:
            raise RuntimeError(
                f"stripe {sid}: {len(lost_blocks)} blocks lost, "
                f"only {code.m} tolerable")
        helpers = [b for b in range(code.n) if b not in lost_blocks][: code.k]
        key = (tuple(lost_data), tuple(helpers))
        if key not in pattern_of:
            pattern_of[key] = len(coeffs)
            coeffs.append(code.repair_coeffs(*key))
        patterns.append(pattern_of[key])
        offs = []
        for b in helpers:
            if b < code.k:
                offs.append((row * code.k + b) * cb)
            else:
                offs.append(blob + len(spare) * cb)
                spare.append((sid, b))
        src_off.append(offs)
        dst_off.append([(row * code.k + b) * cb for b in lost_data]
                       + [-1] * (code.m - len(lost_data)))
        blocks += len(lost_data)
        first_lost = lost_blocks if first_lost is None else first_lost
    return StripeRepair(
        coeffs, np.array(patterns, dtype=np.int64),
        np.array(src_off, dtype=np.int64).reshape(-1, code.k),
        np.array(dst_off, dtype=np.int64).reshape(-1, code.m), spare, blocks,
        first_lost)


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's whole value: a DTensor (a state on a mesh) is gathered
    from its shards, as the reference's `np.asarray` gathers a sharded
    array."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


class ECCheckpointer:
    """Saves and repairs EC checkpoints. Encoding and repair run on
    `device` (`None` = the card; raises without one)."""

    def __init__(self, cfg: ECCheckpointConfig,
                 bw: BandwidthProcess | None = None,
                 ingress: IngressModel | None = None,
                 device=None):
        self.cfg = cfg
        self.code = RSCode(cfg.n, cfg.k)
        self.bw = bw
        self.ingress = ingress or IngressModel()
        self.device = resolve_device(device)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        # seconds of the last save's stages: snapshot (in `save`), then
        # layout, encode, d2h, crc and write (on the writer); and of the
        # last load's: read (files and CRC), h2d (the surviving data
        # blocks to their blob rows, the parity helpers to spare rows),
        # repair (planning and the reconstruct into the blob), assemble
        # (the leaves on their devices)
        self.last_save: dict[str, float] = {}
        self.last_load: dict[str, float] = {}
        os.makedirs(cfg.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def _flatten(self, state) -> tuple[torch.Tensor, dict]:
        """The state's leaves as one uint8 blob on `self.device` (a copy:
        the snapshot), with the manifest's shapes, dtypes and treedef."""
        pairs = tree.items(state)
        leaves = [_whole(leaf).detach() for _, leaf in pairs]
        meta = {
            "shapes": [list(leaf.shape) for leaf in leaves],
            "dtypes": [DTYPE_NAMES[leaf.dtype] for leaf in leaves],
            "treedef": ["/".join(path) for path, _ in pairs],
        }
        rows = [leaf.contiguous().reshape(-1).view(torch.uint8).to(self.device)
                for leaf in leaves]
        blob = (torch.cat(rows) if rows
                else torch.zeros(0, dtype=torch.uint8, device=self.device))
        return blob, meta

    def save(self, step: int, state, *, wait: bool = False) -> str:
        """Snapshot, then encode + write. Async by default (the previous
        save must land first)."""
        tic = time.perf_counter()
        blob, meta = self._flatten(state)
        self._sync()
        snapshot_s = time.perf_counter() - tic
        self.wait()
        self.last_save = {"snapshot": snapshot_s}
        if self.cfg.async_save and not wait:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, blob, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, blob, meta)
        return self._step_dir(step)

    def wait(self):
        """Wait for the save in flight; re-raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the background checkpoint save failed") from err

    def _write_guarded(self, step, blob, meta) -> None:
        try:
            self._write(step, blob, meta)
        except Exception as err:       # handed to the caller by wait()
            self._error = err

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.cfg.directory, f"step_{step:08d}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _clock(self, stage: str, tic: float) -> float:
        self._sync()
        toc = time.perf_counter()
        self.last_save[stage] = toc - tic
        return toc

    def _write(self, step: int, blob: torch.Tensor, meta: dict) -> None:
        cfg, code = self.cfg, self.code
        tic = time.perf_counter()
        total = blob.numel()
        stripe_bytes = code.k * cfg.chunk_bytes
        num_stripes = max(1, -(-total // stripe_bytes))
        padded = torch.zeros(num_stripes * stripe_bytes, dtype=torch.uint8,
                             device=self.device)
        padded[:total] = blob
        # (S, k, C) -> (k, S*C): every stripe's parity in one launch
        data_k = padded.view(num_stripes, code.k, cfg.chunk_bytes).transpose(
            0, 1).contiguous().view(code.k, -1)
        del padded
        tic = self._clock("layout", tic)
        parity = ops.rs_encode(code.parity_coeffs(), data_k)
        tic = self._clock("encode", tic)
        stripes = stripe_lib.place_stripes(num_stripes, code, cfg.num_domains)
        per_domain = _block_order(stripes)
        # blocks in domain-file order, gathered on the device: data block
        # (s, b) is row b * S + s of data_k, parity block j row j * S + s
        rows = torch.cat([data_k, parity]).view(-1, cfg.chunk_bytes)
        del data_k, parity
        order = [b * num_stripes + s for dom in sorted(per_domain)
                 for s, b in per_domain[dom]]
        index = torch.as_tensor(order, dtype=torch.int64, device=self.device)
        host = rows.index_select(0, index).cpu().numpy()
        del rows, index
        tic = self._clock("d2h", tic)

        d = self._step_dir(step)
        os.makedirs(d + ".tmp", exist_ok=True)
        checksums, bufs, at = {}, {}, 0
        for dom in sorted(per_domain):
            nblocks = len(per_domain[dom])
            bufs[dom] = host[at: at + nblocks].reshape(-1)
            at += nblocks
            checksums[str(dom)] = zlib.crc32(bufs[dom])
        crc_s = time.perf_counter() - tic
        tic = time.perf_counter()
        for dom, buf in bufs.items():
            buf.tofile(os.path.join(d + ".tmp", f"domain_{dom}.bin"))
        manifest = {
            "step": step,
            "total_bytes": int(total),
            "n": code.n, "k": code.k,
            "chunk_bytes": cfg.chunk_bytes,
            "num_stripes": num_stripes,
            "num_domains": cfg.num_domains,
            "checksums": {str(dom): checksums[str(dom)]
                          for dom in per_domain},
            **meta,
        }
        with open(os.path.join(d + ".tmp", "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(d + ".tmp", d)                # atomic commit
        self.last_save.update(crc=crc_s, write=time.perf_counter() - tic)

    # ------------------------------------------------------------------ load
    def latest_step(self) -> int | None:
        steps = [int(x.split("_")[1]) for x in os.listdir(self.cfg.directory)
                 if x.startswith("step_") and not x.endswith(".tmp")]
        return max(steps) if steps else None

    def _host_buffer(self, nbytes: int) -> np.ndarray:
        """Host memory the domain files are read into: pinned when they
        go on to a card (one copy at the pinned rate, no staging of its
        own), plain numpy on the CPU, where the tensor shares it."""
        if self.device.type == "cuda":
            return torch.empty(nbytes, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(nbytes, dtype=np.uint8)

    def _read_domains(self, d: str, manifest: dict, lost: set[int],
                      per_domain: dict) -> tuple[np.ndarray, dict[int, int]]:
        """The surviving domain files in one host buffer, each at a slot
        of its expected size, with each good domain's byte offset in it.
        A lost, missing, short or corrupt (CRC) file counts as lost."""
        cb = manifest["chunk_bytes"]
        slots = {}
        for dom in range(manifest["num_domains"]):
            path = os.path.join(d, f"domain_{dom}.bin")
            size = len(per_domain.get(dom, ())) * cb
            if (dom not in lost and os.path.exists(path)
                    and os.path.getsize(path) == size):
                slots[dom] = path
        host = self._host_buffer(sum(len(per_domain[dom]) * cb
                                     for dom in slots))
        out, at = {}, 0
        for dom, path in slots.items():
            view = host[at: at + len(per_domain[dom]) * cb]
            with open(path, "rb") as f:
                got = f.readinto(memoryview(view))
            if (got == view.size and zlib.crc32(view)
                    == manifest["checksums"].get(str(dom))):
                out[dom] = at
            at += view.size
        return host, out

    def load(self, template, *, step: int | None = None,
             lost_domains: tuple[int, ...] = ()) -> tuple[object, RepairReport]:
        """Restore a train state of `template`'s structure; repair any
        blocks on lost domains. Leaves come back on the template's
        devices.

        The surviving domain files are read and CRC-checked on the host,
        and the blob is assembled on `self.device`: each surviving data
        block is copied to its row, each parity block a repair reads to a
        spare row, and one `rs_reconstruct_stripes` launch writes every
        lost data block into its row (none when nothing was lost). Each
        leaf is then copied out of the blob, whose windows (`WINDOW_BYTES`)
        are freed as the copies pass them."""
        code = self.code
        tic = time.perf_counter()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        num_stripes, cb = manifest["num_stripes"], manifest["chunk_bytes"]
        stripes = stripe_lib.place_stripes(num_stripes, code,
                                           manifest["num_domains"])
        per_domain = _block_order(stripes)
        host, bases = self._read_domains(d, manifest, set(lost_domains),
                                         per_domain)
        missing = set(range(manifest["num_domains"])) - set(bases)

        t0 = time.time()
        self.last_load = {"read": time.perf_counter() - tic}
        tic = time.perf_counter()
        plan = plan_repair(code, stripes,
                           {blk for dom in bases for blk in per_domain[dom]},
                           cb)
        sim_result = None
        if plan.first_lost is not None and self.bw is not None:
            sim_result = self._price_repair(plan.first_lost)
        plan_s = time.perf_counter() - tic
        tic = time.perf_counter()
        rows = num_stripes * code.k
        per_window = max(1, WINDOW_BYTES // cb)
        windows = [torch.empty(min(per_window, rows - w) * cb,
                               dtype=torch.uint8, device=self.device)
                   for w in range(0, rows, per_window)]
        spare = torch.empty(len(plan.spare) * cb, dtype=torch.uint8,
                            device=self.device)
        home = {(s.stripe_id, b): r * code.k + b
                for r, s in enumerate(stripes) for b in range(code.k)}
        home.update({blk: rows + j for j, blk in enumerate(plan.spare)})
        files = torch.from_numpy(host)
        for dom, base in bases.items():
            for i, blk in enumerate(per_domain[dom]):
                r = home.get(blk)
                if r is None:
                    continue
                at = base + i * cb
                row = (spare[(r - rows) * cb:][:cb] if r >= rows else
                       windows[r // per_window][r % per_window * cb:][:cb])
                row.copy_(files[at: at + cb], non_blocking=True)
        self._sync()
        del files, host
        self.last_load["h2d"] = time.perf_counter() - tic
        tic = time.perf_counter()
        ops.rs_reconstruct_stripes(plan.coeffs, plan.patterns,
                                   [*windows, spare], plan.src_off,
                                   plan.dst_off, cb)
        self._sync()
        del spare
        self.last_load["repair"] = plan_s + time.perf_counter() - tic
        tic = time.perf_counter()
        state = self._unflatten(windows, manifest, template)
        self._sync()
        self.last_load["assemble"] = time.perf_counter() - tic
        report = RepairReport(
            lost_domains=tuple(sorted(missing)),
            stripes_repaired=len(plan.patterns),
            blocks_repaired=plan.blocks,
            sim=sim_result,
            wall_seconds=time.time() - t0,
        )
        return state, report

    def _unflatten(self, windows: list, meta: dict, template):
        """The manifest's leaves from the blob's bytes (`windows`, its
        parts in order, all of one size but the last), each copied onto
        its template leaf's device into storage of its own, in the
        template's structure. A window is dropped from the list once the
        copies have passed it."""
        devices = [leaf.device for leaf in tree.leaves(template)]
        if len(devices) != len(meta["shapes"]):
            raise ValueError(f"checkpoint holds {len(meta['shapes'])} leaves, "
                             f"the template {len(devices)}")
        size = windows[0].numel()
        out, off = [], 0
        for shape, name, dev in zip(meta["shapes"], meta["dtypes"], devices):
            leaf = torch.empty(shape, dtype=DTYPES[name], device=dev)
            raw = leaf.view(-1).view(torch.uint8)
            at = 0
            while at < raw.numel():
                w, lo = divmod(off + at, size)
                take = min(raw.numel() - at, size - lo)
                raw[at: at + take].copy_(windows[w][lo: lo + take])
                at += take
            out.append(leaf)
            off += raw.numel()
            windows[: off // size] = [None] * (off // size)
        return tree.unflatten(template, out)

    def _price_repair(self, lost_blocks: list[int]) -> SimResult:
        """Price one stripe's repair under the cluster bandwidth process
        using the configured scheme (the paper's algorithms)."""
        cfg = self.cfg
        sc = Scenario(
            num_nodes=max(cfg.num_domains, self.code.n),
            code=self.code,
            failed=tuple(lost_blocks),
            bw=self.bw,
            ingress=self.ingress,
            chunk_mb=cfg.chunk_bytes / 2**20,
        )
        scheme = (cfg.single_scheme if len(lost_blocks) == 1 else cfg.scheme)
        return RepairSimulator(sc).run(scheme)
