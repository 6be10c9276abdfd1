"""Host-side paged KV block pool (port of ``repro.core.block_pool``;
DESIGN.md §9).

The device only sees the per-slot ``block_tbl`` leaf that :class:`BlockPool`
maintains and the engine flushes; a table that changes never changes a
shape and never costs a kernel rebuild.  Everything allocation-shaped lives
here, in numpy, on the host:

* a free list over ``n_blocks`` physical blocks (physical id 0 is the
  reserved **null block**: never allocated, never freed, absorbs writes
  from retired rows, and is what unallocated table entries point at);
* per-block reference counts — prefix sharing means one physical block can
  back the same logical block of many slots;
* a content-hash registry (``key -> phys``): a prompt whose leading blocks
  hash to resident keys reuses those blocks instead of quantizing again;
* per-slot decode **reservations**: admission promises a request the
  blocks its decode will touch, so a slot never stalls mid-generation.

Copy-on-write: full blocks are immutable once registered, but the partial
tail block keeps receiving tokens as decode evicts them from the window.
Before any write to a shared or registered block the engine calls
:meth:`BlockPool.ensure_writable`.

The degradation ladder of DESIGN.md §11 adds two things here:
:class:`HostSpillTier`, the LRU host-RAM tier a registered block's bytes
park in when its last reference drops (the engine sets
:attr:`BlockPool.on_evict` to read them off the device), and the chaos
injector's :meth:`BlockPool.seize` hold, which the audit accounts for.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BlockPool", "HostSpillTier", "prefix_block_keys"]


def prefix_block_keys(prompt: Sequence[int], n_sink: int, window: int,
                      block_tokens: int, seed: str = ""):
    """Content-address a prompt's packed blocks (DESIGN.md §9).

    Returns ``(full_keys, tail_key)``: one chained sha256 key per full
    packed block the prompt quantizes at admission, plus a key for the
    partial tail block (``None`` when the packed region ends on a block
    boundary or packs nothing).  Packed entry ``u`` holds exactly token
    ``n_sink + u``, quantized per token, so two prompts agreeing on
    ``prompt[:n_sink + (lb+1)*block_tokens]`` give bit-identical block
    ``lb``.  ``seed`` folds in everything else content depends on (band,
    policy).  The tail key also encodes its fill count."""
    plen = len(prompt)
    qc = max(0, plen - n_sink - window)        # packed tokens at admission
    h = hashlib.sha256(seed.encode())
    h.update(bytes(f":{n_sink}:{block_tokens}:", "ascii"))
    for tok in prompt[:n_sink]:
        h.update(int(tok).to_bytes(8, "little", signed=True))
    full_keys: List[str] = []
    n_full, fill = divmod(qc, block_tokens)
    for lb in range(n_full):
        for tok in prompt[n_sink + lb * block_tokens:
                          n_sink + (lb + 1) * block_tokens]:
            h.update(int(tok).to_bytes(8, "little", signed=True))
        full_keys.append(h.hexdigest())
    tail_key: Optional[str] = None
    if fill > 0:
        for tok in prompt[n_sink + n_full * block_tokens:n_sink + qc]:
            h.update(int(tok).to_bytes(8, "little", signed=True))
        tail_key = f"P{fill}:{h.hexdigest()}"
    return full_keys, tail_key


class HostSpillTier:
    """LRU host-RAM tier for cold pool blocks (DESIGN.md §11).

    When a hash-registered block's refcount drops to zero the engine parks
    its packed bytes here (numpy arrays, one dict of plane leaves per
    content key) instead of losing them with the device free.  A later
    admission whose prefix key misses the device registry but hits this
    tier *restores* the block with one host->device copy instead of
    inserting it from the prefill's quantized cache.

    ``budget_bytes`` bounds the tier: inserting past it evicts the
    least-recently-used entries (a :meth:`get` refreshes recency).  One
    tier serves every band of an engine: content keys fold in the band and
    policy, so they cannot collide across bands.
    """

    def __init__(self, budget_bytes: int):
        if budget_bytes < 1:
            raise ValueError(
                f"host spill budget must be >= 1 byte, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[str, Tuple[dict, int]]" = OrderedDict()
        self.bytes = 0
        self.spilled = 0          # blocks parked (device -> host copies)
        self.restored = 0         # blocks revived (host -> device copies)
        self.evicted = 0          # LRU drops under budget pressure
        self.rejected = 0         # blocks larger than the whole budget

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def put(self, key: str, arrays: dict, nbytes: int) -> bool:
        """Park one block's plane leaves under ``key``, evicting LRU
        entries until the budget covers it.  False (a counted rejection)
        when one block exceeds the whole budget: the tier never
        over-commits host RAM."""
        nbytes = int(nbytes)
        if nbytes > self.budget_bytes:
            self.rejected += 1
            return False
        if key in self._entries:
            _, old = self._entries.pop(key)
            self.bytes -= old
        while self.bytes + nbytes > self.budget_bytes and self._entries:
            _, (_, old) = self._entries.popitem(last=False)
            self.bytes -= old
            self.evicted += 1
        self._entries[key] = (arrays, nbytes)
        self.bytes += nbytes
        self.spilled += 1
        return True

    def get(self, key: str) -> Optional[dict]:
        """Plane leaves for ``key`` (refreshing its recency), or None."""
        hit = self._entries.get(key)
        if hit is None:
            return None
        self._entries.move_to_end(key)
        return hit[0]

    def pop(self, key: str) -> Optional[dict]:
        """Remove and return ``key``'s plane leaves: the restore path, the
        block is device-resident again."""
        hit = self._entries.pop(key, None)
        if hit is None:
            return None
        arrays, nbytes = hit
        self.bytes -= nbytes
        self.restored += 1
        return arrays

    def stats(self) -> dict:
        """Occupancy and traffic counters for ``Engine.stats()``."""
        return {"budget_bytes": self.budget_bytes, "bytes": self.bytes,
                "entries": len(self._entries), "spilled": self.spilled,
                "restored": self.restored, "evicted": self.evicted,
                "rejected": self.rejected}

    def check_invariants(self) -> None:
        """Audit the byte accounting (DESIGN.md §11): tracked bytes equal
        the sum of entry sizes and never exceed the budget.  Raises
        ``RuntimeError`` on a violation."""
        total = sum(n for _, n in self._entries.values())
        if total != self.bytes:
            raise RuntimeError(
                f"host spill tier byte drift: tracked {self.bytes} != "
                f"summed {total}")
        if self.bytes > self.budget_bytes:
            raise RuntimeError(
                f"host spill tier over budget: {self.bytes} > "
                f"{self.budget_bytes}")


class BlockPool:
    """Free list + refcounts + hash registry + per-slot tables for ONE
    quantized band's physical block pool (DESIGN.md §9).

    One physical block bundles the band's planes across all its layers, so
    the pool allocates per band.  ``n_blocks`` counts allocatable blocks;
    the device pool axis is ``n_blocks + 1`` wide (id 0 is the null block).
    """

    def __init__(self, n_blocks: int, n_slots: int, n_table: int,
                 block_nbytes: int = 0):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.n_slots = int(n_slots)
        self.n_table = int(n_table)
        self.block_nbytes = int(block_nbytes)
        # logical -> physical per slot; 0 = unallocated (null block)
        self.tables = np.zeros((n_slots, n_table), np.int32)
        self.refs = np.zeros(n_blocks + 1, np.int32)
        self.refs[0] = 1                       # null block: pinned forever
        self._free: List[int] = list(range(n_blocks, 0, -1))  # pop() -> 1 first
        self.hash_to_phys: Dict[str, int] = {}
        self.phys_to_hash: Dict[int, str] = {}
        self._reserved = np.zeros(n_slots, np.int64)
        self.hits = 0
        self.misses = 0
        self.cow_copies = 0
        self.peak_used = 0
        self.dirty = True                      # device table needs a flush
        # spill hook (DESIGN.md §11): on_evict(key, phys) when a registered
        # block's refcount hits zero, before it returns to the free list,
        # while its bytes are still on the device
        self.on_evict: Optional[Callable[[str, int], None]] = None
        # chaos holds (DESIGN.md §11): blocks seized out of the free list,
        # in nobody's table, so the audit accounts for them explicitly
        self.seized: set = set()

    # ------------------------------------------------------------- accounting

    def used(self) -> int:
        """Physical blocks currently allocated (excluding the null block)."""
        return self.n_blocks - len(self._free)

    def available(self) -> int:
        """Blocks an admission may still promise: free minus what existing
        slots' decode reservations have already claimed."""
        return len(self._free) - int(self._reserved.sum())

    def reserved(self) -> int:
        """Total outstanding decode reservations across slots."""
        return int(self._reserved.sum())

    def set_reservation(self, slot: int, n: int) -> None:
        """Promise ``slot`` up to ``n`` future blocks (admission contract)."""
        self._reserved[slot] = max(0, int(n))

    def stats(self) -> dict:
        """Occupancy + sharing counters for ``Engine.stats()``/CLI."""
        used = self.used()
        return {"blocks": self.n_blocks, "used": used,
                "free": len(self._free), "reserved": self.reserved(),
                "peak_used": self.peak_used,
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_hit_rate": (self.hits / (self.hits + self.misses)
                                    if self.hits + self.misses else 0.0),
                "cow_copies": self.cow_copies,
                "seized": len(self.seized),
                "resident_bytes": used * self.block_nbytes}

    # ------------------------------------------------------------- allocation

    def alloc(self, slot: int, consume_reservation: bool = False) -> int:
        """Pop a free physical block (refcount 1).  ``consume_reservation``
        burns one of ``slot``'s reserved blocks: decode-time allocations
        were promised at admission."""
        if not self._free:
            raise RuntimeError(
                f"block pool exhausted ({self.n_blocks} blocks, "
                f"{self.reserved()} reserved) — admission accounting bug")
        phys = self._free.pop()
        self.refs[phys] = 1
        if consume_reservation and self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        self.peak_used = max(self.peak_used, self.used())
        return phys

    def ref(self, phys: int) -> None:
        """Take another reference on an allocated block (prefix sharing)."""
        if phys <= 0 or self.refs[phys] <= 0:
            raise ValueError(f"ref on unallocated block {phys}")
        self.refs[phys] += 1

    def deref(self, phys: int) -> None:
        """Drop a reference; the last one frees the block and retires any
        hash registration pointing at it.  A registered block reaching
        zero first fires :attr:`on_evict` (the host spill hook, DESIGN.md
        §11) while its bytes are still resident."""
        if phys <= 0:
            return
        if self.refs[phys] <= 0:
            raise ValueError(f"deref on unallocated block {phys}")
        self.refs[phys] -= 1
        if self.refs[phys] == 0:
            key = self.phys_to_hash.pop(phys, None)
            if key is not None:
                self.hash_to_phys.pop(key, None)
                if self.on_evict is not None:
                    self.on_evict(key, phys)
            self._free.append(phys)

    # ----------------------------------------------------------- hash registry

    def lookup(self, key: str) -> Optional[int]:
        """Resident physical block for a content key, or None."""
        return self.hash_to_phys.get(key)

    def register(self, key: str, phys: int) -> None:
        """Publish ``phys`` as the canonical block for ``key`` (after its
        contents are on the device)."""
        if self.refs[phys] <= 0:
            raise ValueError(f"register of unallocated block {phys}")
        self.hash_to_phys[key] = phys
        self.phys_to_hash[phys] = key

    def deregister(self, phys: int) -> None:
        """Forget a block's content key (it is about to be mutated)."""
        key = self.phys_to_hash.pop(phys, None)
        if key is not None:
            self.hash_to_phys.pop(key, None)

    # ------------------------------------------------------------- slot tables

    def table(self, slot: int) -> np.ndarray:
        """``slot``'s logical -> physical table, flushed into ``block_tbl``."""
        return self.tables[slot]

    def assign(self, slot: int, lb: int, phys: int) -> None:
        """Point logical block ``lb`` of ``slot`` at ``phys``."""
        self.tables[slot, lb] = phys
        self.dirty = True

    def ensure_writable(self, slot: int, lb: int
                        ) -> Optional[Tuple[str, int, int]]:
        """Make logical block ``lb`` of ``slot`` privately writable
        (DESIGN.md §9 CoW contract).  Returns the device work needed:

        * ``None`` — already exclusively owned and unregistered;
        * ``("alloc", phys, 0)`` — entry was unallocated; fresh ``phys``
          assigned (stale contents past the frontier are masked);
        * ``("copy", src, dst)`` — entry was shared; the engine must copy
          src -> dst on the device before the write lands.
        """
        phys = int(self.tables[slot, lb])
        if phys == 0:
            fresh = self.alloc(slot, consume_reservation=True)
            self.assign(slot, lb, fresh)
            return ("alloc", fresh, 0)
        if self.refs[phys] > 1:
            dst = self.alloc(slot, consume_reservation=True)
            self.refs[phys] -= 1               # this slot's share moves away
            self.assign(slot, lb, dst)
            self.cow_copies += 1
            return ("copy", phys, dst)
        # refcount 1: ours, but a registered key could still be matched
        self.deregister(phys)
        return None

    def release_slot(self, slot: int) -> None:
        """Retire a slot: deref every allocated entry, zero its table row,
        drop its reservation."""
        for lb in range(self.n_table):
            phys = int(self.tables[slot, lb])
            if phys > 0:
                self.deref(phys)
        self.tables[slot] = 0
        self._reserved[slot] = 0
        self.dirty = True

    # ------------------------------------------------- faults + audit (§11)

    def seize(self, n: int) -> List[int]:
        """Take up to ``n`` blocks out of the free list without assigning
        them to a slot: the pool-exhaustion chaos injector's hold
        (DESIGN.md §11), tracked so the audit tells a hold from a leak."""
        out: List[int] = []
        for _ in range(max(0, int(n))):
            if not self._free:
                break
            phys = self._free.pop()
            self.refs[phys] = 1
            self.seized.add(phys)
            out.append(phys)
        self.peak_used = max(self.peak_used, self.used())
        return out

    def release_seized(self, blocks: Optional[Sequence[int]] = None) -> None:
        """Return seized blocks (default: all of them) to the free list,
        the end of a chaos exhaustion burst (DESIGN.md §11)."""
        for phys in list(blocks if blocks is not None else self.seized):
            if phys not in self.seized:
                raise ValueError(f"block {phys} was not seized")
            self.seized.discard(phys)
            self.refs[phys] = 0
            self._free.append(phys)

    def check_invariants(self) -> dict:
        """Refcount / free-list / registry audit (DESIGN.md §11); raises
        ``RuntimeError`` naming the violation:

        * the null block stays pinned;
        * the free list holds exactly the refcount-zero blocks, without
          duplicates, and ``used + free == n_blocks``;
        * every allocated block's refcount equals its table occurrences,
          plus one if the chaos injector seized it;
        * reservations never exceed the free list;
        * the hash registry is a bijection onto live blocks.
        """
        def fail(msg: str):
            raise RuntimeError(f"BlockPool invariant violated: {msg} "
                               f"(stats: {self.stats()})")

        if self.refs[0] < 1:
            fail("null block lost its pin")
        free = list(self._free)
        if len(set(free)) != len(free):
            fail("duplicate entries in the free list")
        for phys in free:
            if not (1 <= phys <= self.n_blocks):
                fail(f"free-list entry {phys} out of range")
            if self.refs[phys] != 0:
                fail(f"free block {phys} has refcount {self.refs[phys]}")
        if self.used() + len(free) != self.n_blocks:
            fail(f"used ({self.used()}) + free ({len(free)}) != "
                 f"n_blocks ({self.n_blocks})")
        occ = np.bincount(self.tables.reshape(-1),
                          minlength=self.n_blocks + 1)
        if (self.tables == 0).sum() != occ[0]:
            fail("table occupancy miscount")
        for phys in range(1, self.n_blocks + 1):
            want = int(occ[phys]) + (1 if phys in self.seized else 0)
            if int(self.refs[phys]) != want:
                fail(f"block {phys}: refcount {int(self.refs[phys])} != "
                     f"{int(occ[phys])} table refs"
                     + (" + 1 seized" if phys in self.seized else ""))
        if int(self._reserved.sum()) > len(free):
            fail(f"reservations ({int(self._reserved.sum())}) exceed the "
                 f"free list ({len(free)})")
        for key, phys in self.hash_to_phys.items():
            if self.phys_to_hash.get(phys) != key:
                fail(f"registry asymmetry at key {key[:12]}…")
            if self.refs[phys] <= 0:
                fail(f"registered block {phys} is not allocated")
        for phys, key in self.phys_to_hash.items():
            if self.hash_to_phys.get(key) != phys:
                fail(f"registry asymmetry at block {phys}")
        return {"blocks": self.n_blocks, "used": self.used(),
                "free": len(free), "seized": len(self.seized),
                "registered": len(self.hash_to_phys),
                "reserved": self.reserved()}
