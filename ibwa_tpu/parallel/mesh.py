"""Multi-device / multi-host layout for the aln engine (SURVEY.md §2.6).

Reads are the data axis — the reference's pthread work-claiming
(bwtaln.c:100-113) becomes batch sharding over a `dp` mesh — and the
FM-index block table is replicated per device (the reference shares one
read-only index across threads, bwtaln.c:212).  Every device reaches
every other at the same rate, so the mesh follows the algorithm alone: a
flat `dp` axis over all visible devices.  A human-genome-scale table (32
B rows at 64-base blocks, about 1.6 GB for both strands) fits one
device's memory many times over.  The table can also shard contiguously
over a second `idx` mesh axis (`make_mesh_2d` +
`run_sharded_index_search`; fm/device.py::_gather_block does the masked
local gather + psum) — bit-identical to the replicated path
(tests/test_sharded_index.py).

Multi-host: run one process per host under `jax.distributed.initialize`;
each host feeds its local shard of the read batch (per-host fastq
shards), and the same jit works unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align import engine_jax
from ..fm.device import DeviceFmPair


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D `dp` mesh over the requested devices (defaults to all)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("dp",))


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    return len({d.process_index for d in mesh.devices.flat}) > 1


def to_local_np(a) -> "np.ndarray":
    """Materialize the process-local rows of a dp-sharded result array.

    Single-controller arrays come back whole; under `jax.distributed`
    each process sees exactly the rows it fed (its addressable shards,
    in dp order) — the multi-host analog of the reference's per-process
    `.sai` stream (bwtaln.c:192)."""
    if getattr(a, "is_fully_addressable", True):
        return np.asarray(a)
    shards = sorted(a.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])


def shard_inputs(mesh: Mesh, dfm: DeviceFmPair, arrays: tuple):
    """Place the index replicated and the read batch sharded over dp.

    Under a multi-process mesh, `arrays` are interpreted as the caller's
    process-LOCAL read rows (each process feeds its own shard); the
    replicated FM index must hold identical values in every process
    (true by construction: all processes load the same artifacts)."""
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("dp"))
    # device_put straight from host memory (jnp.asarray would bounce the
    # buffers through the default backend when the mesh is on another one)
    put = lambda a, s: a if (isinstance(a, jax.Array)
                             and a.sharding == s) else jax.device_put(a, s)
    fm_args = tuple(put(a, repl)
                    for a in (dfm.blocks, dfm.L2, dfm.l2diff, dfm.primary))
    fm_args += (None if dfm.dimer is None
                else tuple(put(a, repl) for a in dfm.dimer),)
    if mesh_is_multiprocess(mesh):
        batch = tuple(
            a if isinstance(a, jax.Array)
            else jax.make_array_from_process_local_data(shard, a)
            for a in arrays)
    else:
        batch = tuple(put(a, shard) for a in arrays)
    return fm_args, batch


def run_sharded_search(cfg, mesh: Mesh, dfm: DeviceFmPair, seqs, lens,
                       max_diff, has_seed, seed_seqs, bad):
    """Jit + run one sharded aln search step over the mesh.

    The batch axis must be divisible by the mesh size; the search is
    embarrassingly parallel over reads, so XLA partitions the whole
    while-loop without cross-device collectives (the `any` in the loop
    condition becomes the only psum)."""
    fm_args, batch = shard_inputs(
        mesh, dfm, (seqs, lens, max_diff, has_seed, seed_seqs, bad))
    with mesh:
        return engine_jax._run_search(
            cfg, *fm_args[:4], *batch,
            seq_len=dfm.seq_len, n_blk=dfm.n_blk, dimer=fm_args[4])


@functools.lru_cache(maxsize=None)
def _persistent_sharded_fn(cfg, mesh: Mesh, seq_len: int, n_blk: int,
                           n_lanes: int):
    """Compiled per-(config, mesh) sharded persistent search; cached so the
    production path does not retrace on every chunk dispatch."""

    def local(blocks, L2, l2diff, primary, dimer, *b):
        hits, n_hits, fb, it = engine_jax._run_search_persistent.__wrapped__(
            cfg, blocks, L2, l2diff, primary, *b,
            seq_len=seq_len, n_blk=n_blk, n_lanes=n_lanes, dimer=dimer)
        return hits, n_hits, fb, it[None]

    repl = P()
    shard = P("dp")
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(repl, repl, repl, repl, repl) + (shard,) * 6,
        out_specs=(shard, shard, shard, shard),
        check_vma=False))


def run_sharded_search_persistent(cfg, mesh: Mesh, dfm: DeviceFmPair, seqs,
                                  lens, max_diff, has_seed, seed_seqs, bad,
                                  n_lanes: int):
    """The production path over a mesh: per-device persistent schedulers.

    shard_map (not whole-array pjit) so each device runs its own
    persistent-lane while_loop over its read shard with NO per-step
    cross-device sync — a device that drains its shard early simply
    finishes, instead of the whole mesh stepping until the globally
    slowest lane drains (the reference's pthread work-claiming has the
    same property within a host, bwtaln.c:100-113)."""
    fm_args, batch = shard_inputs(
        mesh, dfm, (seqs, lens, max_diff, has_seed, seed_seqs, bad))
    fn = _persistent_sharded_fn(cfg, mesh, dfm.seq_len, dfm.n_blk, n_lanes)
    return fn(*fm_args, *batch)


def make_mesh_2d(n_dp: int, n_idx: int, devices=None) -> Mesh:
    """A ("dp", "idx") mesh: reads sharded over dp, the FM block table
    sharded over idx (the >single-chip-HBM mode)."""
    devs = list(devices) if devices is not None else jax.devices()
    devs = devs[:n_dp * n_idx]
    return Mesh(np.array(devs).reshape(n_dp, n_idx), ("dp", "idx"))


def run_sharded_index_search(cfg, mesh: Mesh, dfm: DeviceFmPair, seqs,
                             lens, max_diff, has_seed, seed_seqs, bad,
                             n_lanes: int):
    """Search with the FM block table SHARDED over the idx axis.

    Each idx shard holds a contiguous row range, every occ gather
    fetches the rows it owns and psums the one-hot rows over the idx
    axis (fm/device.py::_gather_block).  Reads stay data-parallel over
    dp; within an idx group all lanes step in lockstep, so the psum is
    the only added cost (one block row per query)."""
    n_idx = mesh.shape["idx"]
    if dfm.blocks.shape[0] % n_idx:
        raise ValueError(
            f"block rows {dfm.blocks.shape[0]} not divisible by idx="
            f"{n_idx}; pad the table (padding rows are never addressed)")

    def local(blocks, L2, l2diff, primary, *b):
        hits, n_hits, fb, it = engine_jax._run_search_persistent.__wrapped__(
            cfg, blocks, L2, l2diff, primary, *b,
            seq_len=dfm.seq_len, n_blk=dfm.n_blk, n_lanes=n_lanes,
            shard_axis="idx")
        return hits, n_hits, fb, it[None]

    repl = P()
    shard = P("dp")
    # outputs are identical across the idx group (lanes run in lockstep on
    # psum'd rows), so idx is left unmentioned in out_specs (replicated)
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("idx"), repl, repl, repl) + (shard,) * 6,
        out_specs=(shard, shard, shard, shard),
        check_vma=False))
    fm_args = tuple(jnp.asarray(a) for a in
                    (dfm.blocks, dfm.L2, dfm.l2diff, dfm.primary))
    batch = tuple(jnp.asarray(a) for a in
                  (seqs, lens, max_diff, has_seed, seed_seqs, bad))
    return fn(*fm_args, *batch)
