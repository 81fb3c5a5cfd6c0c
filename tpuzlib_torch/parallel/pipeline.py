"""Sharded codec pipelines over a torch.distributed mesh (parallel/mesh.py).

Counterpart of tpuzlib/parallel/pipeline.py.  Every rank compresses its
shard of the input with the previous shard's tail as dictionary context;
where tpuzlib's step is one shard_map, the port's is one SPMD function
that every rank runs on its own shard:

  1. halo exchange   - each rank sends its last `ctx` bytes to its right
                       neighbour (batch_isend_irecv, where tpuzlib's ring
                       ppermute also sent the last shard's tail to shard 0,
                       which discards it: ctx_valid is 0 there);
  2. local compress  - the port's batched dynamic-Huffman encoder
                       (kernels/deflate_device3.make_encode_batch_v3, one
                       chunk a rank: the screens, the parse and pack_words
                       on a card);
  3. checksum combine- each rank's Adler-32 and CRC-32 of its valid bytes
                       (one adler32_scalar and one crc32_scalar launch on a
                       card); the Adler (S, W) pairs merge positionally and
                       the raw CRC forms, shifted past the valid bytes
                       after them by each shard's GF(2) suffix matrix,
                       XOR-combine as a bit-planed sum: one all_reduce;
  4. gather          - every rank gathers every shard's words, bit count
                       and ok flag (all_gather) and joins the bits on the
                       host (BitSink, deflate_shards), so every rank
                       returns the same stream, as tpuzlib's global arrays
                       do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import crc32 as crc_k
from ..kernels.adler32 import MOD

_M32 = 0xFFFFFFFF


def _shard_shift_matrix_bits(shard_len: int, ndev: int, n: int | None = None) -> np.ndarray:
    """(ndev, 32, 32) int32: bit matrix of A^(suffix_bytes) per shard.

    Shard i's raw CRC form must be shifted past the VALID bytes that
    follow it (n = total valid length; defaults to the full padded
    extent)."""
    if n is None:
        n = shard_len * ndev
    mats = np.zeros((ndev, 32, 32), dtype=np.int32)
    for i in range(ndev):
        suffix = max(n - (i + 1) * shard_len, 0)
        cols = crc_k.shift_matrix(suffix)  # packed u32 cols
        # bits[c, r] = bit r of column c; out_bit[r] = XOR_c in_bit[c]*bits[c,r]
        mats[i] = (cols[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return mats


def build_sharded_deflate(mesh, shard_len: int, level: int = 6, ctx: int | None = None):
    """The SPMD deflate step over `mesh`: (run, ctx), built once a (mesh,
    shard_len, level, ctx) and then reused (_build_step).

    run(shard, n), called by every rank with its own shard (shard_len
    bytes, a uint8 tensor or host array, zero past the valid length) and
    the stream's valid length n, returns what tpuzlib's step returns, on
    the mesh's device: every shard's packed words (ndev, out_words) as
    int64 holding u32, bit counts and ok flags (ndev,) int32 (ok 0: a
    token or output cap overflowed, and the host writes that shard as
    stored blocks), and the stream's Adler sums S and W and raw CRC form
    L as 0-d int64 tensors, the same on every rank.  The checksums cover
    the valid bytes only."""
    if ctx is None:
        ctx = min(1 << 15, shard_len)
    if shard_len % 128 or ctx % 128:
        raise ValueError("shard_len and ctx must be multiples of 128 (screen tiling)")
    return _build_step(mesh, shard_len, level, ctx), ctx


@functools.lru_cache(maxsize=16)
def _build_step(mesh, shard_len: int, level: int, ctx: int):
    """build_sharded_deflate's run, memoized: a call of sharded_deflate
    builds no encoder when its step exists (a bounded cache, since a
    destroyed process group's mesh is never asked for again)."""
    from ..kernels.adler32_cuda import adler32_device_scalar
    from ..kernels.crc32_cuda import crc32_device_scalar
    from ..kernels.deflate_device3 import make_encode_batch_v3, out_words_for

    ndev, idx, dev, group = mesh.size, mesh.rank, mesh.device, mesh.group
    out_words = out_words_for(shard_len)
    encode = make_encode_batch_v3(level, shard_len, 1, out_words, ctx=ctx)
    bit_pos = torch.arange(32, dtype=torch.int64, device=dev)
    shift_cache = {}

    def run(shard, n: int):
        shard = torch.as_tensor(shard, dtype=torch.uint8).to(dev)
        n_valid = min(max(n - idx * shard_len, 0), shard_len)
        # 1. halo: the last ctx bytes travel to the right neighbour
        halo = torch.zeros(ctx, dtype=torch.uint8, device=dev)
        ops = []
        if idx + 1 < ndev:
            ops.append(dist.P2POp(dist.isend, shard[-ctx:].contiguous(), idx + 1, group))
        if idx > 0:
            ops.append(dist.P2POp(dist.irecv, halo, idx - 1, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        # a shard with data (n_valid > 0, idx > 0) always has a fully
        # valid predecessor, so its halo is real history
        ctx_valid = 0 if idx == 0 or n_valid == 0 else ctx
        buf = torch.cat([halo, shard])[None]

        # 2. local compress: one dynamic-Huffman chunk a rank
        scalars = [torch.tensor([v], dtype=torch.int32, device=dev)
                   for v in (ctx_valid, n_valid, int(idx == ndev - 1))]
        words, nbits, ok = encode(buf, *scalars)

        # 3a. adler: this shard's S = sum x and W = sum (n_valid - i) x_i,
        # W carried past the `suffix` valid bytes after the shard
        valid = shard[:n_valid]
        adler = adler32_device_scalar(valid)
        s_local = ((adler & 0xFFFF) - 1) % MOD
        w_local = ((adler >> 16) - n_valid) % MOD
        suffix = max(n - (idx + 1) * shard_len, 0)
        w_contrib = (w_local + (suffix % MOD) * s_local) % MOD

        # 3b. crc: the raw form L = crc ^ ~0 ^ A^n_valid(~0), shifted by the
        # shard's suffix matrix, its bits summed over the ranks
        if n not in shift_cache:
            shift_cache[n] = torch.from_numpy(
                _shard_shift_matrix_bits(shard_len, ndev, n)[idx].astype(np.int64)).to(dev)
        undo = _M32 ^ crc_k.gf2.apply(crc_k.shift_matrix(n_valid), _M32)
        l_local = crc32_device_scalar(valid) ^ undo
        in_bits = (l_local >> bit_pos) & 1
        out_bits = (in_bits[:, None] * shift_cache[n]).sum(0) & 1
        sums = torch.cat([torch.stack([s_local, w_contrib]), out_bits])
        dist.all_reduce(sums, group=group)
        s_g, w_g = sums[0] % MOD, sums[1] % MOD
        l_g = ((sums[2:] & 1) << bit_pos).sum()

        # 4. gather every shard's words, bit count and ok flag
        mine = torch.cat([words[0], nbits.to(torch.int64), ok.to(torch.int64)])
        parts = [torch.empty_like(mine) for _ in range(ndev)]
        dist.all_gather(parts, mine, group=group)
        every = torch.stack(parts)
        return (every[:, :out_words], every[:, out_words].to(torch.int32),
                every[:, out_words + 1].to(torch.int32), s_g, w_g, l_g)

    return run


def deflate_shards(data: np.ndarray, mesh, level: int = 6, shard_len: int | None = None):
    """sharded_deflate without its zlib container: every rank's call with
    the whole input returns (the raw DEFLATE stream, adler32, crc32, the
    step's ok flags (ndev,)), the same on every rank."""
    from ..codec.bitsink import BitSink
    from ..common import u8_view
    from ..kernels.deflate_device3 import _push_stored

    data = np.ascontiguousarray(u8_view(data))
    ndev = mesh.size
    n = len(data)
    if shard_len is None:
        shard_len = max(4096, -(-n // ndev))
        shard_len = (shard_len + 4095) & ~4095  # multiple of 4096
    if shard_len * ndev < n:
        raise ValueError("%d shards of %d bytes cannot hold %d bytes" % (ndev, shard_len, n))
    shard = np.zeros(shard_len, dtype=np.uint8)
    lo = min(mesh.rank * shard_len, n)
    mine = data[lo : min(lo + shard_len, n)]
    shard[: len(mine)] = mine
    run, _ = build_sharded_deflate(mesh, shard_len, level)
    words, nbits, ok, s_g, w_g, l_g = (t.cpu().numpy() for t in run(shard, n))

    sink = BitSink()
    for i in range(ndev):
        lo, hi = i * shard_len, min((i + 1) * shard_len, n)
        nv = max(hi - lo, 0)
        tb = int(nbits[i])
        nstored = max(1, -(-nv // 65535))
        stored_bits = 8 * nv + nstored * (3 + 32) + 8
        if nv and (not ok[i] or tb > stored_bits):
            _push_stored(sink, data[lo:hi], i == ndev - 1)
            continue
        if nv == 0 and i < ndev - 1:
            continue  # empty non-final shard: emit nothing
        if nv == 0:
            # empty final shard: a final empty stored block closes the
            # stream.  The last shard is empty whenever
            # n <= (ndev - 1) * shard_len, not only when n == 0; the
            # shards before it then wrote no final block.
            _push_stored(sink, np.empty(0, np.uint8), True)
            continue
        nfull = tb >> 5
        if nfull:
            sink.push(words[i, :nfull].astype(np.uint64), np.full(nfull, 32, np.int64))
        rem = tb & 31
        if rem:
            sink.push_scalar(int(words[i, nfull]) & ((1 << rem) - 1), rem)
    body, _, _ = sink.flush(final=True)

    s1 = (1 + int(s_g)) % MOD
    s2 = ((n % MOD) * 1 + int(w_g)) % MOD
    adler = (s2 << 16) | s1
    crc = (int(l_g) ^ crc_k.gf2.apply(crc_k.shift_matrix(n), _M32)) ^ _M32
    return body, adler, crc & _M32, ok


def sharded_deflate(data: np.ndarray, mesh, level: int = 6, shard_len: int | None = None):
    """Every rank's call with the whole input (of any length): pad and
    shard it, run the SPMD step on this rank's shard, join the bits and
    wrap them in a zlib container with the mesh-combined Adler-32.
    Returns (zlib bytes, adler32, crc32), the same on every rank.

    Padding never reaches the output: each shard compresses only its
    valid bytes and checksums are computed over the valid region.  A
    shard whose encode overflowed its caps (ok=0) or whose dynamic block
    lost to byte-aligned stored blocks is emitted as stored blocks on the
    host, the per-chunk choice deflate_device_v3 makes (reference
    _tr_flush_block stored choice, deflate.ts:648)."""
    from ..common import u8_view
    from ..containers.headers import make_zlib_header, make_zlib_trailer

    body, adler, crc, _ = deflate_shards(data, mesh, level, shard_len)
    out = np.concatenate([u8_view(make_zlib_header(level)), body,
                          u8_view(make_zlib_trailer(adler))])
    return out, adler, crc


def sharded_inflate(data, mesh, stride_bits: int = 1 << 15, max_cursors: int = 4096,
                    size_hint: int | None = None, dictionary=None):
    """Mesh-parallel raw-DEFLATE decode (the multi-device inflate path):
    inflate_device_v2 with the cursor decode sharded over the mesh's ranks
    (kernels/inflate_device2.mesh_decode), the compressed stream
    replicated; the splice, compaction and expansion then run on every
    rank.  Returns the decompressed bytes, the same on every rank, or None
    where the stream needs the host engine (the caller falls back).

    Only the decode shards: it is most of the work and independent over
    cursors, while the expansion resolves back-references by pointer
    doubling over the whole output (a DEFLATE reference may reach through
    the 32 KiB window of every earlier block), which sharded would need
    an all_gather of the output a doubling step.  size_hint is the
    decode's (the device expansion's first capacity; no byte depends on
    it)."""
    from ..kernels.inflate_device2 import inflate_device_v2

    return inflate_device_v2(data, dictionary=dictionary, stride_bits=stride_bits,
                             max_cursors=max_cursors, size_hint=size_hint, mesh=mesh)
