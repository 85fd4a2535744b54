"""Decode GetRateLimitsResp wire bytes into columns, vectorised.

A response is a run of field-1 records (RateLimitResp items). An item
carries status (1), limit (2), remaining (3), reset_time (4) as varints,
error (5) as a string and metadata (6) as map entries; proto3 leaves out
fields equal to 0. Written from the protobuf encoding rules, without the
port's codec.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Answers(NamedTuple):
    status: np.ndarray  # int64, 0 UNDER_LIMIT, 1 OVER_LIMIT
    limit: np.ndarray  # int64
    remaining: np.ndarray  # int64
    reset: np.ndarray  # int64
    error: np.ndarray  # bool: the item carries an error string
    items: np.ndarray  # int64 items in each response
    malformed: int  # records that are not of this message's shape


def varints(buf: np.ndarray, pos: np.ndarray):
    """The varint at each position of `buf` (uint8, padded with 10 zero
    bytes past its end): (values int64, lengths int64). Values above 2**63
    wrap to negative int64, as protobuf's int64 does."""
    val = np.zeros(pos.shape[0], np.uint64)
    length = np.zeros(pos.shape[0], np.int64)
    live = np.ones(pos.shape[0], bool)
    for k in range(10):
        b = buf[pos + k]
        val |= np.where(live, (b & 0x7F).astype(np.uint64) << np.uint64(7 * k), 0).astype(np.uint64)
        length += live
        live &= (b & 0x80) != 0
        if not live.any():
            break
    return val.astype(np.int64), length


def decode(responses: List[bytes]) -> Answers:
    """Every item of every response, in order."""
    sizes = np.fromiter((len(r) for r in responses), np.int64, len(responses))
    buf = np.frombuffer(b"".join(responses) + bytes(16), np.uint8)
    ends = np.cumsum(sizes)
    cur = ends - sizes
    starts, lens, owner = [], [], []
    malformed = 0
    idx = np.nonzero(sizes > 0)[0]
    while idx.size:
        c = cur[idx]
        tag = buf[c]
        bad = tag != 0x0A
        malformed += int(bad.sum())
        n, nb = varints(buf, c + 1)
        starts.append(c + 1 + nb)
        lens.append(n)
        owner.append(idx)
        cur[idx] = np.where(bad, ends[idx], c + 1 + nb + n)
        idx = idx[cur[idx] < ends[idx]]
    if starts:
        start = np.concatenate(starts)
        length = np.concatenate(lens)
        who = np.concatenate(owner)
        order = np.lexsort((start, who))
        start, length, who = start[order], length[order], who[order]
    else:
        start = length = who = np.zeros(0, np.int64)
    m = start.size
    cols = {f: np.zeros(m, np.int64) for f in (1, 2, 3, 4)}
    err = np.zeros(m, bool)
    p = start.copy()
    end = start + length
    act = np.nonzero(p < end)[0]
    while act.size:
        pa = p[act]
        tag = buf[pa].astype(np.int64)
        field, wt = tag >> 3, tag & 7
        v, nb = varints(buf, pa + 1)
        isv = wt == 0
        for f in (1, 2, 3, 4):
            sel = isv & (field == f)
            cols[f][act[sel]] = v[sel]
        err[act[(wt == 2) & (field == 5)]] = True
        step = np.where(isv, 1 + nb, np.where(wt == 2, 1 + nb + v, end[act] - pa))
        malformed += int(((wt != 0) & (wt != 2)).sum())
        p[act] = pa + step
        act = act[p[act] < end[act]]
    malformed += int((p != end).sum())
    items = np.bincount(who, minlength=len(responses)).astype(np.int64)
    return Answers(cols[1], cols[2], cols[3], cols[4], err, items, malformed)
