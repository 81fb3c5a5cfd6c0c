"""inflate_members(): the client reads a pool of BAM slices in turn, one
call after another, each a 32 MiB region of a coordinate-sorted BAM
file's records in BGZF members.

The records follow the SAM/BAM specification's section 4.2 layout, made
with numpy from the seed (`records`): 2 x 150 bp read pairs at 30x
coverage over a reference drawn for the slice, Illumina read names,
NovaSeq's four binned qualities, one CIGAR op, and the tags NM, AS, XS,
RG and MD; every record 331 bytes.  Each seed gets the same generator
and sizes, so the work does not change with the seed.  A slice is cut at
the traffic's piece_bytes, its members written by Python's zlib
(reference/bgzf_ref.py) in a thread pool, then the EOF member.

The timed call is inflate_members() (TIMES: the inflate cell's readers
and metric files read it).  A sample of the outputs drawn from the seed
(traffic "keep_share", and always each slice's first) is kept and
compared byte for byte with its records after the window.  The control
is the plain reference with the last data member's last byte dropped.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..reference import bgzf_ref, zlib_ref

TIMES = "inflate"

RECORD = 331  # bytes a record: 36 fixed, name 38, CIGAR 4, seq 75, qual 150, tags 28
READ = 150
NAME = b"A00217:5:HKWVNDSXY:1:1101:00000:00000\0"  # lane, tile, x and y filled in
QUALS = np.array([2, 12, 23, 37], np.uint8)  # NovaSeq's binned Phred scores
NIBBLE = np.array([1, 2, 4, 8], np.uint8)  # A C G T in BAM's 4-bit code
BASES = np.frombuffer(b"ACGT", np.uint8)


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    """x (non-negative ints) as zero-padded ASCII digits, (len(x), width)."""
    return (x[:, None] // 10 ** np.arange(width - 1, -1, -1) % 10 + 48).astype(np.uint8)


def _put(rec: np.ndarray, col: int, values, dtype: str) -> None:
    """values as little-endian `dtype` into the columns from `col` on."""
    v = np.broadcast_to(np.asarray(values).astype(dtype), (len(rec),))
    b = np.ascontiguousarray(v).view(np.uint8).reshape(len(rec), -1)
    rec[:, col : col + b.shape[1]] = b


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The UCSC bin of [beg, end) (the specification's reg2bin, section 5.3)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & (beg >> shift == end >> shift)
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def records(n: int, seed) -> np.ndarray:
    """n bytes of coordinate-sorted BAM records (section 4.2), the last one
    cut where the n bytes end, as a region slice cuts them."""
    rng = np.random.default_rng(seed)
    count = -(-n // RECORD)
    pairs = -(-count // 2)
    # fragment starts: 30x coverage of 150 bp reads is a read every 5 bp
    starts = 1_000_000 + np.cumsum(rng.geometric(1 / 10, pairs))
    insert = np.clip(rng.normal(350, 50, pairs), 160, 700).astype(np.int64)
    pos = np.concatenate([starts, starts + insert - READ])
    frag = np.concatenate([np.arange(pairs), np.arange(pairs)])
    mate = np.concatenate([np.zeros(pairs, bool), np.ones(pairs, bool)])
    order = np.argsort(pos, kind="stable")[:count]
    pos, frag, mate = pos[order], frag[order], mate[order]
    mate_pos = np.where(mate, pos - insert[frag] + READ, pos + insert[frag] - READ)
    reverse = rng.random(pairs) < 0.5  # which mate reads the reverse strand
    first_rev = reverse[frag] ^ mate
    flag = np.where(mate, np.where(first_rev, 147, 163), np.where(first_rev, 83, 99))

    span = int(pos.max() - pos.min()) + READ
    ref = rng.integers(0, 4, span)
    seq = ref[(pos - pos.min())[:, None] + np.arange(READ)]
    # one mismatch a read, at 50..99: a SNP or a sequencing error
    at = rng.integers(50, 100, count)
    row = np.arange(count)
    was = seq[row, at]
    seq[row, at] = (was + rng.integers(1, 4, count)) % 4
    nib = NIBBLE[seq]
    # the low bins grow toward the read's end
    fall = rng.random((count, READ)) * (1 - np.arange(READ) / 450)
    qual = QUALS[np.searchsorted([0.02, 0.07, 0.15], fall)]

    rec = np.zeros((count, RECORD), np.uint8)
    _put(rec, 0, RECORD - 4, "<i4")  # block_size
    _put(rec, 4, 0, "<i4")  # refID
    _put(rec, 8, pos, "<i4")
    rec[:, 12] = len(NAME)  # l_read_name
    rec[:, 13] = np.where(rng.random(count) < 0.05, rng.integers(0, 60, count), 60)  # MAPQ
    _put(rec, 14, _reg2bin(pos, pos + READ), "<u2")
    _put(rec, 16, 1, "<u2")  # n_cigar_op
    _put(rec, 18, flag, "<u2")
    _put(rec, 20, READ, "<i4")  # l_seq
    _put(rec, 24, 0, "<i4")  # next_refID
    _put(rec, 28, mate_pos, "<i4")
    _put(rec, 32, np.where(mate_pos > pos, 1, -1) * insert[frag], "<i4")  # tlen
    name = np.tile(np.frombuffer(NAME, np.uint8), (count, 1))
    lane, tile = frag % 4 + 1, 1101 + frag // 4 % 1578
    name[:, 19] = 48 + lane
    name[:, 21:25] = _digits(tile, 4)
    name[:, 26:31] = _digits(rng.integers(1000, 32000, pairs)[frag], 5)
    name[:, 32:37] = _digits(rng.integers(1000, 37000, pairs)[frag], 5)
    rec[:, 36:74] = name
    _put(rec, 74, READ << 4, "<u4")  # 150M
    rec[:, 78:153] = nib[:, 0::2] << 4 | nib[:, 1::2]
    rec[:, 153:303] = qual
    tags = np.frombuffer(b"NMC\x01ASC\x00XSC\x00RGZHG2\x00MDZ", np.uint8)
    rec[:, 303:325] = tags
    rec[:, 310] = 145  # AS: 150 less 5 a mismatch
    rec[:, 314] = rng.integers(0, 120, count)  # XS
    rec[:, 325:327] = _digits(at, 2)
    rec[:, 327] = BASES[was]
    rec[:, 328:330] = _digits(READ - 1 - at, 2)
    rec[:, 330] = 0
    return rec.reshape(-1)[:n]


def program(api, config: dict, device):
    fn = api.inflate_members  # looked up now: a port without it fails before set-up

    def call(wire):
        return fn(wire, device=device)

    return call


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        n = traffic["piece_bytes"]
        self.pieces = [records(n, [seed, k]) for k in range(traffic["pool"])]
        jobs = [p for piece in self.pieces for p in bgzf_ref.pieces(piece, config)]
        with ThreadPoolExecutor(8) as pool:  # zlib lets go of the GIL
            members = list(pool.map(lambda d: bgzf_ref.member(d, config), jobs))
        self.wires, at = [], 0
        for piece in self.pieces:
            k = len(bgzf_ref.pieces(piece, config))
            self.wires.append(np.frombuffer(b"".join(members[at : at + k])
                                            + bgzf_ref.EOF_MEMBER, np.uint8))
            at += k
        self.keep = np.random.default_rng([seed, 1])
        self.share = traffic["keep_share"]
        self.calls = 0
        self.outputs = []  # (slice, output)

    def warm(self, fn) -> None:
        for wire in self.wires:
            fn(wire)

    def call(self, fn) -> tuple[int, int]:
        k = self.calls % len(self.wires)
        out = fn(self.wires[k])
        if self.calls < len(self.wires) or self.keep.random() < self.share:
            self.outputs.append((k, out))
        self.calls += 1
        return len(self.wires[k]), len(out)


def check(config: dict, traffic: dict, d: Driver) -> tuple[dict, dict]:
    bad = sum(not zlib_ref.equal(out, d.pieces[k]) for k, out in d.outputs)
    return {"bad_outputs": (bad, 0)}, {"outputs_checked": len(d.outputs)}


def control(api, config: dict, device):
    """The plain reference with the last data member's last byte dropped
    (the EOF member after it adds none)."""
    def call(wire):
        return np.frombuffer(bgzf_ref.read(wire), np.uint8)[:-1]

    return call
