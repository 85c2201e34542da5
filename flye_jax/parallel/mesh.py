"""Device-mesh distribution for the assembly pipeline.

The reference is single-node shared-memory: concurrent cuckoo maps +
atomics over a thread pool (reference: src/common/parallel.h:14-58 and
the 13 processInParallel sites catalogued in SURVEY §2.3).  The
replacement here is a `jax.sharding.Mesh` with two logical axes:

  data   — read batches stream data-parallel (one shard per device/host),
           mirroring every "parallel over reads" loop;
  shard  — the minimizer index is hash-sharded across devices for large
           genomes (replicated for small ones).

K-mer histograms merge with psum; per-shard overlap hits merge with
all_gather — the collective analog of the reference's shared-memory
reductions.  Everything here compiles under jit over the mesh
(tests/test_distributed_pipeline.py checks it on a virtual CPU mesh,
chip_smoke.py --four-cards on four GPUs).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flye_jax.ops.chain import chain_dp
from flye_jax.ops.kmers import kmer_hashes, minimizer_mask

HIST_BUCKETS = 1 << 16  # hash-bucketed k-mer histogram size


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("data",)) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    devs = np.asarray(devices[:n])
    if len(axes) == 1:
        return Mesh(devs, axes)
    # 2D (data, shard): factor n into the most square grid
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            return Mesh(devs.reshape(n // d, d), axes)
    return Mesh(devs.reshape(n, 1), axes)


def _local_step(codes, lengths, cur, ext, nmatch, k: int, w: int,
                max_jump: int, lookback: int):
    """Per-shard compute: minimizer selection + bucketed k-mer histogram
    + chain DP. This is the device-plane inner loop of the assembly
    pipeline (index build + overlap chaining)."""
    canon, h, valid = kmer_hashes(codes, lengths, k)
    sel = minimizer_mask(h, valid, w)
    buckets = (h % jnp.uint64(HIST_BUCKETS)).astype(jnp.int32)
    weights = sel.astype(jnp.int32)
    hist = jnp.zeros(HIST_BUCKETS, dtype=jnp.int32).at[
        buckets.reshape(-1)].add(weights.reshape(-1))
    # merge histograms across the data axis — the collective replacing
    # the reference's shared atomic counter array
    hist = jax.lax.psum(hist, axis_name="data")
    score, parent = chain_dp(cur, ext, nmatch, k, max_jump, lookback)
    n_sel = jax.lax.psum(sel.sum(), axis_name="data")
    return hist, score, parent, n_sel


SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def posting_exchange_step(mesh: Mesh, n_per_dev: int, cap: int):
    """Build the jitted all-to-all posting exchange for the hash-sharded
    index: each device extracts (kmer, payload) postings from its local
    read partition and routes every posting to the device owning
    hash(kmer) % n_dev; each device then sorts its received shard.

    This is the multi-host analog of the reference's concurrent-map
    index insert (reference: vertex_index.cpp:389-483 — threads insert
    into a shared cuckoo map; here shards exchange postings over ICI and
    each sorts locally, keeping the build deterministic).

    Inputs (global, sharded over 'data'):
      kmers   [n_dev * n_per_dev] uint64, SENTINEL = empty padding
      payload [n_dev * n_per_dev] int64 (packed seq/pos/flip)
    Outputs:
      sorted received kmers   [n_dev * n_dev * cap] (P('data')),
      sorted received payload [same],
      n_dropped per device [n_dev] (postings beyond cap capacity),
      n_recv per device [n_dev].
    """
    from flye_jax.ops.kmers import splitmix64

    n_dev = mesh.shape["data"]

    def local(kmers, payload):
        kmers = kmers.reshape(-1)
        payload = payload.reshape(-1)
        valid = kmers != SENTINEL
        h = splitmix64(kmers)
        dest = jnp.where(valid,
                         (h % jnp.uint64(n_dev)).astype(jnp.int32),
                         jnp.int32(n_dev))
        # slot = rank of this posting within its destination group
        oh = jax.nn.one_hot(dest, n_dev + 1, dtype=jnp.int32)
        slot = ((jnp.cumsum(oh, axis=0) - oh) * oh).sum(axis=1)
        send_k = jnp.full((n_dev, cap), SENTINEL,
                          dtype=jnp.uint64).at[
            dest, slot].set(kmers, mode="drop")
        send_p = jnp.zeros((n_dev, cap), jnp.int64).at[
            dest, slot].set(payload, mode="drop")
        kept = ((dest < n_dev) & (slot < cap)).sum()
        n_dropped = valid.sum() - kept

        recv_k = jax.lax.all_to_all(send_k, "data", split_axis=0,
                                    concat_axis=0, tiled=True)
        recv_p = jax.lax.all_to_all(send_p, "data", split_axis=0,
                                    concat_axis=0, tiled=True)
        sk, sp = jax.lax.sort((recv_k.reshape(-1), recv_p.reshape(-1)),
                              num_keys=2)
        n_recv = (sk != SENTINEL).sum()
        return (sk[None], sp[None],
                n_dropped.astype(jnp.int32)[None],
                n_recv.astype(jnp.int32)[None])

    spec = P("data")
    fn = jax.jit(
        jax.shard_map(local, mesh=mesh,
                      in_specs=(spec, spec),
                      out_specs=(spec, spec, spec, spec),
                      check_vma=False))

    def prepare(kmers: np.ndarray, payload: np.ndarray):
        """Pad host posting arrays to the sharded global shape."""
        n = len(kmers)
        total = n_dev * n_per_dev
        if n > total:
            raise ValueError(f"{n} postings > capacity {total}")
        pk = np.full(total, SENTINEL, dtype=np.uint64)
        pp = np.zeros(total, dtype=np.int64)
        pk[:n] = kmers
        pp[:n] = payload
        sharding = NamedSharding(mesh, spec)
        return (jax.device_put(pk, sharding),
                jax.device_put(pp, sharding))

    return fn, prepare


def sharded_pipeline_step(mesh: Mesh, k: int = 15, w: int = 5,
                          max_jump: int = 1500, lookback: int = 64):
    """Build a jitted, mesh-sharded pipeline step.

    Returns (fn, make_example_args(per_shard_batch, read_len, n_matches)).
    Inputs are sharded over the 'data' axis; the k-mer histogram is
    replicated after the psum.
    """
    data_spec = P("data")

    local = functools.partial(_local_step, k=k, w=w, max_jump=max_jump,
                              lookback=lookback)
    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(data_spec, data_spec, data_spec, data_spec, data_spec),
            out_specs=(P(), data_spec, data_spec, P()),
            check_vma=False,
        ))

    n_data = mesh.shape["data"]

    def make_example_args(batch_per_shard: int = 2, read_len: int = 256,
                          n_matches: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        B = batch_per_shard * n_data
        codes = rng.integers(0, 4, size=(B, read_len)).astype(np.uint8)
        lengths = np.full(B, read_len, dtype=np.int32)
        cur = np.sort(rng.integers(0, 4000, size=(B, n_matches)),
                      axis=1).astype(np.int32)
        ext = (cur + 100).astype(np.int32)
        nmatch = np.full(B, n_matches, dtype=np.int32)
        sharding = NamedSharding(mesh, data_spec)
        return tuple(jax.device_put(x, sharding)
                     for x in (codes, lengths, cur, ext, nmatch))

    return fn, make_example_args
