"""Prefix cache: a radix tree over prompt tokens with two storage backends
(a copy of ``repro.serve.prefix_cache``: the port keeps its own, importing
nothing of the JAX package).

LUNA's thesis is that *reuse beats recomputation* — serving traffic makes
the same bet at the request level: million-user workloads lead with a
shared system-prompt head, so the engine should pay its prefill cost once
and look the result up afterwards.  This module is the host-side index for
that lookup; the engine (``repro_torch.serve.engine``) drives it at admission.

Tree structure
--------------
A compressed radix tree: each node's ``edge`` is the token run from its
parent, ``depth`` is the total prefix length ending at the node.  Inserting
a prompt that diverges mid-edge SPLITS the edge; matching walks whole edges
only (a partial edge never yields a payload — the next insert materializes
the split point, and later requests hit it).

Node payloads (either or both, per serving family):

* ``blocks`` — physical ids of the paged-pool blocks holding this prefix's
  attention KV, ``floor(depth / block_size)`` of them (whole blocks only).
  The cache co-owns them through the backend's block refcounts; an admission
  that matches shares them COPY-ON-WRITE into the request's block table —
  the request refs them, reads them in place, and never writes them (tail
  writes land in freshly-allocated private blocks; the engine redirects the
  shared range of its prefill scatter to the garbage block).  When a node
  is split, the new internal node derives ``blocks[:mid_depth // bs]`` from
  its child — a shared HEAD becomes matchable the moment the first
  divergent request is inserted.
* ``state`` — the recurrent families' fixed-size dense snapshot
  (conv_state, ssd_state) captured AT ``depth`` from the state-continuing
  SSD scan.  Unlike attention KV, recurrent state cannot be truncated: a
  snapshot serves exactly its own boundary, so matching returns the deepest
  node whose snapshot depth fits.

Eviction is LRU over leaf nodes.  When the block pool runs short
(``evict_for``), only *unreferenced* leaves count — nodes whose blocks no
active request shares (backend refcount == the cache's own holds); blocks
return to the free pool strictly at refcount 0, so eviction can never yank
a page out from under a live block table.  The node-budget trim
(``max_nodes``, bounding snapshot memory) may drop any LRU leaf — request
refs keep shared block content alive regardless.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class _Node:
    __slots__ = ("parent", "edge", "children", "depth", "blocks", "state",
                 "last_used")

    def __init__(self, parent: "_Node | None", edge: tuple[int, ...],
                 depth: int):
        self.parent = parent
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.depth = depth
        self.blocks: list[int] | None = None
        self.state = None
        self.last_used = 0


@dataclass
class PrefixHit:
    """One admission-time match: reuse ``length`` prompt tokens."""
    length: int                       # tokens of prefill skipped
    blocks: list[int] = field(default_factory=list)   # shared COW blocks
    state: object | None = None       # recurrent snapshot at ``length``


class PrefixCache:
    """Radix tree + payload store.  ``block_size``/``backend`` bind the
    paged substrate: ``backend`` is any object exposing the narrow block-op
    surface ``ref(blocks)`` / ``release(blocks)`` / ``refcount(block)`` /
    ``free_blocks`` (a ``repro_torch.serve.backend.PagedPool`` in the engine; a
    raw ``BlockAllocator`` satisfies the same protocol in tests).  Leave
    both None for the pure recurrent-state backend (mamba2's dense
    engine)."""

    def __init__(self, *, block_size: int | None = None,
                 backend=None, max_nodes: int = 256):
        assert (block_size is None) == (backend is None)
        if max_nodes < 1:
            raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
        self.block_size = block_size
        self.backend = backend
        self.max_nodes = max_nodes
        self._root = _Node(None, (), 0)
        self._tick = 0
        self.node_count = 0
        self.evictions = 0            # lifetime total (engine metrics diff)
        self.lookups = 0              # lifetime match() calls
        self.hits = 0                 # lifetime match() calls that hit
        # cache-side owner count per block id: how many node payloads hold
        # it.  backend.refcount(b) == _block_owners[b] <=> no live request
        # shares b, which is what pool-shortage eviction needs to know.
        self._block_owners: dict[int, int] = {}

    # --- matching -------------------------------------------------------
    def match(self, tokens: list[int], *, max_len: int,
              need_state: bool = False) -> PrefixHit | None:
        """Longest cached prefix of ``tokens`` usable at admission.

        ``max_len`` caps the reused length (the engine passes
        ``len(prompt) - 1`` — at least one tail token must run through
        prefill to produce the last-position logits).  ``need_state``:
        recurrent families need a snapshot AT the boundary; attention-only
        families can take any whole-block prefix of a deeper node's blocks.
        """
        self._tick += 1
        self.lookups += 1
        node, depth, best = self._root, 0, None
        while True:
            hit = self._usable(node, max_len, need_state)
            if hit is not None:
                best = (node, hit)
            if depth >= len(tokens):
                break
            child = node.children.get(tokens[depth])
            if child is None:
                break
            e = child.edge
            rest = tuple(tokens[depth:depth + len(e)])
            if rest != e:
                # partial edge: no state boundary lives mid-edge, but the
                # matched span's whole blocks ARE usable — token equality
                # is verified up to depth+m and a block list truncates
                # cleanly (the shared-system-prompt case: the first
                # divergent request reuses the head before any split
                # materializes it as a node)
                m = _common_len(e, rest)
                part = self._partial(child, depth + m, max_len, need_state)
                if part is not None and (best is None
                                         or part.length > best[1].length):
                    best = (child, part)
                break
            node, depth = child, depth + len(e)
        if best is None:
            return None
        node, hit = best
        self.hits += 1
        n = node
        while n is not None:          # refresh the whole hit path's LRU age
            n.last_used = self._tick
            n = n.parent
        return hit

    def _partial(self, child: _Node, matched: int, max_len: int,
                 need_state: bool) -> PrefixHit | None:
        """Blocks-only hit from a partially-matched edge: ``matched``
        tokens of the prefix ending at ``child`` are verified equal."""
        if need_state or self.block_size is None or child.blocks is None:
            return None
        nb = min(len(child.blocks), matched // self.block_size,
                 max_len // self.block_size)
        if nb < 1:
            return None
        return PrefixHit(nb * self.block_size, list(child.blocks[:nb]), None)

    def _usable(self, node: _Node, max_len: int,
                need_state: bool) -> PrefixHit | None:
        if node is self._root:
            return None
        if need_state:
            if node.state is None or node.depth > max_len:
                return None
            if self.block_size is not None:
                # hybrid: the boundary needs blocks covering [0, depth)
                if (node.blocks is None or node.depth % self.block_size
                        or len(node.blocks) * self.block_size < node.depth):
                    return None
                return PrefixHit(node.depth,
                                 list(node.blocks[:node.depth
                                                  // self.block_size]),
                                 node.state)
            return PrefixHit(node.depth, [], node.state)
        if node.blocks is None or self.block_size is None:
            return None
        nb = min(len(node.blocks), max_len // self.block_size)
        if nb < 1:
            return None
        return PrefixHit(nb * self.block_size, list(node.blocks[:nb]), None)

    # --- insertion ------------------------------------------------------
    def insert(self, tokens: list[int], *, blocks: list[int] | None = None,
               state=None) -> None:
        """Cache a payload at boundary ``len(tokens)``.  ``blocks`` are the
        request's own pool blocks for [0, len(tokens)) — the cache becomes
        a co-owner (refs them); existing payloads at the boundary are kept
        (first writer wins: both copies are equally valid and re-refing
        would leak)."""
        if not tokens or (blocks is None and state is None):
            return
        self._tick += 1
        node, depth = self._root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                new = _Node(node, tuple(tokens[depth:]), len(tokens))
                node.children[tokens[depth]] = new
                self.node_count += 1
                node, depth = new, len(tokens)
                break
            e = child.edge
            rest = tuple(tokens[depth:depth + len(e)])
            m = _common_len(e, rest)
            if m == len(e):
                node, depth = child, depth + len(e)
                continue
            node, depth = self._split(child, m), depth + m
        assert node.depth == len(tokens), (node.depth, len(tokens))
        if blocks is not None and node.blocks is None and self.block_size:
            keep = list(blocks[:len(tokens) // self.block_size])
            if keep:
                self.backend.ref(keep)
                self._own(keep, +1)
                node.blocks = keep
        if state is not None and node.state is None:
            node.state = state
        node.last_used = self._tick
        self.trim()

    def _split(self, child: _Node, m: int) -> _Node:
        """Split ``child``'s edge after ``m`` tokens; the new internal node
        derives the whole-block prefix of the child's payload so the shared
        head is immediately matchable."""
        assert 0 < m < len(child.edge)
        parent = child.parent
        mid = _Node(parent, child.edge[:m], child.depth - len(child.edge) + m)
        parent.children[child.edge[0]] = mid
        child.edge = child.edge[m:]
        child.parent = mid
        mid.children[child.edge[0]] = child
        mid.last_used = child.last_used
        if child.blocks is not None and self.block_size is not None:
            derived = list(child.blocks[:mid.depth // self.block_size])
            if derived:
                self.backend.ref(derived)
                self._own(derived, +1)
                mid.blocks = derived
        self.node_count += 1
        return mid

    # --- eviction -------------------------------------------------------
    def evict_for(self, n_blocks: int) -> int:
        """Pool shortage: evict LRU *unreferenced* leaves until the
        backend can hand out ``n_blocks`` (or no candidate remains).
        Returns the number of nodes evicted."""
        if self.backend is None:
            return 0
        count = 0
        while self.backend.free_blocks < n_blocks:
            victim = self._lru_leaf(unreferenced_only=True)
            if victim is None:
                break
            self._evict(victim)
            count += 1
        return count

    def trim(self) -> int:
        """Node-budget eviction (bounds recurrent-snapshot memory)."""
        count = 0
        while self.node_count > self.max_nodes:
            victim = self._lru_leaf(unreferenced_only=False)
            if victim is None:
                break
            self._evict(victim)
            count += 1
        return count

    def _leaves(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def _unreferenced(self, node: _Node) -> bool:
        """No live request co-owns this node's blocks: every ref is
        accounted for by cache-node payloads."""
        if node.blocks is None:
            return True
        return all(self.backend.refcount(b) == self._block_owners.get(b, 0)
                   for b in node.blocks)

    def _lru_leaf(self, *, unreferenced_only: bool) -> _Node | None:
        best = None
        for n in self._leaves():
            if unreferenced_only and not self._unreferenced(n):
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        return best

    def _evict(self, node: _Node) -> None:
        assert not node.children and node.parent is not None
        # only payload-bearing nodes count as evictions: the recursive
        # cleanup of payload-less structural parents below drops no cached
        # boundary, so it must not inflate the metric past the evict_for/
        # trim return values
        if node.blocks is not None or node.state is not None:
            self.evictions += 1
        if node.blocks is not None:
            self._own(node.blocks, -1)
            self.backend.release(node.blocks)   # frees only at refcount 0
            node.blocks = None
        node.state = None
        node.parent.children.pop(node.edge[0])
        self.node_count -= 1
        parent = node.parent
        # structural nodes left payload-less and childless are dead weight
        if (parent is not self._root and not parent.children
                and parent.blocks is None and parent.state is None):
            self._evict(parent)

    def _own(self, blocks: list[int], delta: int) -> None:
        for b in blocks:
            c = self._block_owners.get(b, 0) + delta
            assert c >= 0, b
            if c:
                self._block_owners[b] = c
            else:
                self._block_owners.pop(b, None)


def _common_len(a: tuple[int, ...], b: tuple[int, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n
