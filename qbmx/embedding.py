"""First-party minor-embedding: hardware graphs, embedding search, chip
partitioning, chain encode/decode, and an embedding cache.

This is the qbmx twin of the reference's embedding pipeline
(``src/embedding.py`` + the model-side cache at
``src/model/faster_dqbm.py:152-165``), owned first-party instead of
delegated to minorminer/pymetis (VERDICT r4 Missing #1):

* :func:`chimera_graph` — a first-party hardware-graph generator (the
  reference ships pre-pickled Pegasus artifacts; qbmx generates Chimera
  topologies and accepts ANY adjacency/edgelist for other chips).
* :func:`clique_embedding_chimera` — deterministic complete-graph
  embedding into a Chimera cell block.  qbmx QUBOs are dense (clamped
  H×H, unclamped (O+H)² — ``src/model/faster_dqbm.py:225-284``), so the
  clique embedding covers every model QUBO of a given size, exactly like
  the reference caching one embedding per hidden-node count.
* :func:`find_embedding` — generic path-based heuristic search (the
  minorminer role, ``src/embedding.py:33-39``) for arbitrary source
  structures and target graphs, with :func:`escalating_find_embedding`
  mirroring the reference's escalating-effort ladder
  (``iterative_search``, ``src/embedding.py:115-160``).
* :func:`partition_target` — balanced BFS region growing (the
  ``pymetis.part_graph`` role, ``src/embedding.py:193-200``) with the
  reference's buffer-node removal semantics
  (``create_subgraphs_with_buffer``, ``:206-223``).
* :func:`embed_qubo` / :func:`unembed_samples` — chain encoding
  (distribute linear terms over the chain, split couplings over the
  available physical couplers, ferromagnetic chain penalty) and
  majority-vote decoding (the ``dwave.embedding.embed_bqm`` /
  ``unembed_sampleset`` roles).
* :class:`EmbeddingCache` — compute once per QUBO structure, reuse for
  the whole training run, optionally persisted to disk (the reference
  pickles ``embeddings_{clamped,unclamped}_<H>.pkl`` per hidden count).

Everything here is host-side Python/numpy by design: embedding is a
once-per-run graph computation on the way to EXTERNAL annealer hardware,
not accelerator compute (SURVEY §2a: "keep the interface seam").
"""

from __future__ import annotations

import hashlib
import heapq
import pickle
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# hardware graphs


def adjacency_from_edgelist(edges, nodes=None) -> dict:
    """Edge list → ``{node: set(neighbors)}`` adjacency dict."""
    adj: dict = {int(v): set() for v in (nodes or ())}
    for u, v in edges:
        u, v = int(u), int(v)
        if u == v:
            adj.setdefault(u, set())
            continue
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return adj


def chimera_index(r: int, c: int, s: int, k: int, m: int, n: int, t: int) -> int:
    """(row, col, shore, shore-index) → linear qubit id.

    Shore 0 qubits couple VERTICALLY (same column, adjacent rows); shore 1
    qubits couple HORIZONTALLY.  Within a cell the two shores form K_{t,t}.
    """
    return ((r * n + c) * 2 + s) * t + k


def chimera_graph(m: int, n: int | None = None, t: int = 4) -> dict:
    """First-party Chimera C_{m,n,t} adjacency (2·t·m·n qubits).

    The reference never generates a topology (it loads D-Wave's Pegasus via
    ``dwave_networkx``, ``src/embedding.py:52``); qbmx owns a generator so
    the embedding pipeline — and its tests — need no vendor SDK."""
    n = m if n is None else n
    adj: dict = {q: set() for q in range(2 * t * m * n)}

    def add(a, b):
        adj[a].add(b)
        adj[b].add(a)

    for r in range(m):
        for c in range(n):
            for i in range(t):  # internal K_{t,t}
                for j in range(t):
                    add(chimera_index(r, c, 0, i, m, n, t),
                        chimera_index(r, c, 1, j, m, n, t))
            for k in range(t):
                if r + 1 < m:  # vertical couplers on shore 0
                    add(chimera_index(r, c, 0, k, m, n, t),
                        chimera_index(r + 1, c, 0, k, m, n, t))
                if c + 1 < n:  # horizontal couplers on shore 1
                    add(chimera_index(r, c, 1, k, m, n, t),
                        chimera_index(r, c + 1, 1, k, m, n, t))
    return adj


def target_fingerprint(adj: dict) -> str:
    """Stable content hash of a target graph (cache key component): an
    embedding computed for one chip must not be replayed onto another."""
    edges = sorted((min(u, v), max(u, v)) for u in adj for v in adj[u])
    h = hashlib.sha1()
    h.update(np.asarray(sorted(adj), dtype=np.int64).tobytes())
    h.update(np.asarray(edges, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# embeddings: construction, search, validation


def clique_embedding_chimera(n_vars: int, m: int, n: int | None = None,
                             t: int = 4, cell_offset=(0, 0)) -> dict | None:
    """Deterministic K_{n_vars} embedding into an A×A Chimera cell block
    (A = ceil(n_vars / t)), translated by ``cell_offset`` cells.

    Variable v = a·t + k chains the vertical shore-0 line of column ``a``
    (rows 0..A-1, shore index k) with the horizontal shore-1 line of row
    ``a`` (cols 0..A-1) — the two lines meet at the diagonal cell (a, a)
    through an internal coupler, and any two chains cross (and couple)
    inside cell (a, b).  Chain length 2A; the block is fully self-contained,
    so copies place into DISJOINT blocks by translation alone — the
    partition-aware analogue of the reference embedding one QUBO copy per
    METIS subgraph (``src/embedding.py:193-223``).  (The minimal known
    Chimera clique embedding reaches K_{t·m+1} with chains of m+1; this
    construction tops out at K_{t·m} with chains of 2A — a documented
    simplicity/optimality trade, irrelevant below the chip's capacity.)

    Returns ``{var: tuple(qubit, ...)}`` or ``None`` when the block does
    not fit the chip.
    """
    n = m if n is None else n
    if n_vars < 1:
        return None
    A = -(-n_vars // t)
    dr, dc = cell_offset
    if dr + A > m or dc + A > n:
        return None
    emb = {}
    for v in range(n_vars):
        a, k = divmod(v, t)
        vertical = [chimera_index(dr + r, dc + a, 0, k, m, n, t) for r in range(A)]
        horizontal = [chimera_index(dr + a, dc + c, 1, k, m, n, t) for c in range(A)]
        emb[v] = tuple(vertical + horizontal)
    return emb


def verify_embedding(embedding: dict, source_edges, target_adj: dict,
                     allow_missing_vars=()) -> list[str]:
    """Validity report (empty list = valid): chains non-empty, on-chip,
    pairwise DISJOINT, CONNECTED, and every source edge realized by at
    least one physical coupler — the checks the reference scatters over
    ``are_qubits_reused`` / ``are_qubits_neighbors``
    (``src/embedding.py:50-80``)."""
    problems = []
    seen: dict = {}
    for v, chain in embedding.items():
        chain = list(chain)
        if not chain:
            problems.append(f"var {v}: empty chain")
            continue
        for q in chain:
            if q not in target_adj:
                problems.append(f"var {v}: qubit {q} not on the target graph")
            if q in seen and seen[q] != v:
                problems.append(f"qubit {q} reused by vars {seen[q]} and {v}")
            seen[q] = v
        # connectivity by BFS within the chain
        chain_set = set(chain)
        frontier, visited = [chain[0]], {chain[0]}
        while frontier:
            q = frontier.pop()
            for p in target_adj.get(q, ()):
                if p in chain_set and p not in visited:
                    visited.add(p)
                    frontier.append(p)
        if visited != chain_set:
            problems.append(f"var {v}: chain {sorted(chain_set)} is disconnected")
    for u, v in source_edges:
        if u in allow_missing_vars or v in allow_missing_vars:
            continue
        cu, cv = embedding.get(u), embedding.get(v)
        if cu is None or cv is None:
            problems.append(f"source edge ({u},{v}): variable missing a chain")
            continue
        if not any(p in target_adj.get(q, ()) for q in cu for p in cv):
            problems.append(f"source edge ({u},{v}): no physical coupler between chains")
    return problems


def _dijkstra_from_chain(chain, target_adj, weight):
    """Node-weighted shortest paths from a chain (cost 0 on chain qubits).
    Returns (dist, parent); parent of a first-step qubit is the chain qubit
    it left from (so paths can stop before re-entering the chain)."""
    dist = {q: 0.0 for q in chain}
    parent: dict = {}
    heap = [(0.0, q) for q in chain]
    heapq.heapify(heap)
    while heap:
        d, q = heapq.heappop(heap)
        if d > dist.get(q, np.inf):
            continue
        for p in target_adj[q]:
            nd = d + weight(p)
            if nd < dist.get(p, np.inf):
                dist[p] = nd
                parent[p] = q
                heapq.heappush(heap, (nd, p))
    return dist, parent


def _route_var(v, source_adj, chains, target_adj, usage, rng, alpha):
    """Chain for ``v``: pick the root minimizing the summed node-weighted
    distance to every already-embedded neighbor chain, then take the union
    of the shortest paths (each path stops one step short of the neighbor
    chain it grew from)."""
    def weight(q):
        return float(alpha ** min(usage.get(q, 0), 12))

    neighbor_chains = [chains[u] for u in source_adj.get(v, ()) if u in chains]
    nodes = list(target_adj)
    if not neighbor_chains:
        free = [q for q in nodes if usage.get(q, 0) == 0]
        return {rng.choice(free if free else nodes)}

    dists, parents = zip(*(_dijkstra_from_chain(c, target_adj, weight)
                           for c in neighbor_chains))
    taken = set().union(*(set(c) for c in neighbor_chains))
    best_root, best_cost = None, np.inf
    for q in nodes:
        if q in taken:
            continue
        cost = weight(q)
        for d in dists:
            dq = d.get(q)
            if dq is None:
                cost = np.inf
                break
            cost += dq
        if cost < best_cost:
            best_root, best_cost = q, cost
    if best_root is None:
        return None
    chain = {best_root}
    for ci, (d, par) in enumerate(zip(dists, parents)):
        q = best_root
        cset = set(neighbor_chains[ci])
        while q not in cset:
            chain.add(q)
            q = par.get(q)
            if q is None:  # root was a source seed of this chain: done
                break
    return chain


def find_embedding(source_edges, target_adj: dict, *, variables=None,
                   seed: int = 0, tries: int = 4, rounds: int = 16,
                   alpha: float = 4.0) -> dict | None:
    """Heuristic minor-embedding search (the ``minorminer.find_embedding``
    role, ``src/embedding.py:33-39``): path-based placement with exponential
    overlap penalties, then re-routing rounds until chains are disjoint.

    ``tries`` independent restarts × ``rounds`` refinement rounds each —
    the knobs the escalation ladder turns.  Returns ``{var: tuple(qubits)}``
    or ``None``.
    """
    source_edges = [(u, v) for u, v in source_edges if u != v]
    source_adj: dict = {}
    for u, v in source_edges:
        source_adj.setdefault(u, set()).add(v)
        source_adj.setdefault(v, set()).add(u)
    for v in variables or ():
        source_adj.setdefault(v, set())
    if not source_adj:
        return {}
    if len(source_adj) > len(target_adj):
        return None

    rng = np.random.default_rng(seed)
    variables = sorted(source_adj, key=lambda v: (-len(source_adj[v]), v))

    for attempt in range(tries):
        order = list(variables)
        if attempt:
            rng.shuffle(order)
        usage: dict = {}
        chains: dict = {}
        ok = True
        for v in order:  # initial placement, overlaps allowed
            chain = _route_var(v, source_adj, chains, target_adj, usage, rng, alpha)
            if chain is None:
                ok = False
                break
            chains[v] = chain
            for q in chain:
                usage[q] = usage.get(q, 0) + 1
        if not ok:
            continue
        for _ in range(rounds):  # re-route overfull chains until disjoint
            overfull = {q for q, c in usage.items() if c > 1}
            if not overfull:
                break
            bad = [v for v in order if chains[v] & overfull]
            rng.shuffle(bad)
            for v in bad:
                for q in chains[v]:
                    usage[q] -= 1
                others = {u: c for u, c in chains.items() if u != v}
                chain = _route_var(v, source_adj, others, target_adj, usage, rng, alpha)
                if chain is None:
                    chain = chains[v]
                chains[v] = chain
                for q in chain:
                    usage[q] = usage.get(q, 0) + 1
        if max(usage.values(), default=0) <= 1:
            emb = {v: tuple(sorted(c)) for v, c in chains.items()}
            if not verify_embedding(emb, source_edges, target_adj):
                return emb
    return None


#: (tries, rounds) effort ladder — the shape of the reference's escalating
#: ``iterative_search`` retries (``src/embedding.py:121-158``), bounded at
#: sane host cost instead of its 25600-second final rung.
EFFORT_LADDER = ((2, 8), (4, 16), (8, 32), (16, 64))


def escalating_find_embedding(source_edges, target_adj: dict, *, variables=None,
                              seed: int = 0, ladder=EFFORT_LADDER) -> dict | None:
    """Escalating-effort search: retry :func:`find_embedding` with bigger
    budgets until one rung succeeds (``iterative_search`` semantics)."""
    for rung, (tries, rounds) in enumerate(ladder):
        emb = find_embedding(source_edges, target_adj, variables=variables,
                             seed=seed + 1000 * rung, tries=tries, rounds=rounds)
        if emb is not None:
            return emb
    return None


# ---------------------------------------------------------------------------
# chip partitioning (the pymetis role)


def partition_target(target_adj: dict, k: int, *, seed: int = 0,
                     buffer: bool = False) -> list[set]:
    """Split a hardware graph into ``k`` balanced connected regions by
    multi-source BFS growth from farthest-point seeds — the
    ``pymetis.part_graph`` stand-in (``src/embedding.py:193-200``).

    ``buffer=True`` additionally drops every endpoint of a cross-region
    coupler (the reference's ``create_subgraphs_with_buffer``,
    ``src/embedding.py:206-223``), leaving regions with no physical path
    between them.  For same-chip parallel QUBO copies plain node-disjoint
    regions already suffice (unused couplers are simply not programmed),
    so the default is False.
    """
    nodes = sorted(target_adj)
    if k < 1 or k > len(nodes):
        raise ValueError(f"cannot partition {len(nodes)} nodes into {k} regions")
    rng = np.random.default_rng(seed)

    def bfs_dist(srcs):
        dist = {q: 0 for q in srcs}
        frontier = list(srcs)
        while frontier:
            nxt = []
            for q in frontier:
                for p in target_adj[q]:
                    if p not in dist:
                        dist[p] = dist[q] + 1
                        nxt.append(p)
            frontier = nxt
        return dist

    seeds = [nodes[rng.integers(len(nodes))]]
    while len(seeds) < k:  # farthest-point seeding
        dist = bfs_dist(seeds)
        # unreachable nodes (disconnected components — defect-split chips)
        # rank as INFINITELY far, so every component gets a seed before any
        # component is split further
        far = max(nodes, key=lambda q: dist.get(q, np.inf))
        seeds.append(far)

    owner = {q: i for i, q in enumerate(seeds)}
    frontiers = [{q for p in (s,) for q in target_adj[p] if q not in owner}
                 for s in seeds]
    sizes = [1] * k
    while any(frontiers):
        i = min((j for j in range(k) if frontiers[j]), key=lambda j: sizes[j],
                default=None)
        if i is None:
            break
        frontier = frontiers[i]
        q = min(frontier)  # deterministic growth
        frontier.discard(q)
        if q in owner:
            continue
        owner[q] = i
        sizes[i] += 1
        for p in target_adj[q]:
            if p not in owner:
                frontier.add(p)
    regions = [{q for q, o in owner.items() if o == i} for i in range(k)]
    if buffer:
        buffer_nodes = set()
        for q, o in owner.items():
            for p in target_adj[q]:
                if owner.get(p, o) != o:
                    buffer_nodes.update((q, p))
        regions = [r - buffer_nodes for r in regions]
    return regions


def subgraph(target_adj: dict, region: set) -> dict:
    """Induced-subgraph adjacency restricted to ``region``."""
    return {q: target_adj[q] & region for q in region}


# ---------------------------------------------------------------------------
# chain encode / decode


def _ising_couplings(qdict: dict):
    """Off-diagonal QUBO terms → Ising couplings (J = Q/4) for chain-strength
    estimation (x = (s+1)/2)."""
    return [abs(v) / 4.0 for (i, j), v in qdict.items() if i != j and v]


def chain_strength_for(qdict: dict, prefactor: float = 1.414) -> float:
    """RMS-torque chain strength (the role of Ocean's
    ``uniform_torque_compensation`` default the reference leans on via
    ``embed_bqm``): prefactor · rms(|J|) · sqrt(average logical degree),
    floored at 1.0 so pure-linear problems still hold chains together."""
    J = _ising_couplings(qdict)
    if not J:
        return 1.0
    n_vars = len({i for k in qdict for i in k})
    avg_degree = 2.0 * len(J) / max(n_vars, 1)
    return max(1.0, prefactor * float(np.sqrt(np.mean(np.square(J))))
               * float(np.sqrt(max(avg_degree, 1.0))))


def embed_qubo(qdict: dict, embedding: dict, target_adj: dict,
               chain_strength: float | None = None) -> dict:
    """Logical QUBO dict → physical QUBO dict on the hardware graph (the
    ``dwave.embedding.embed_bqm`` role, ``src/model/faster_dqbm.py:385``):

    * linear terms split equally over the chain's qubits,
    * couplings split equally over every available physical coupler
      between the two chains,
    * each intra-chain coupler gets the ferromagnetic penalty
      ``-4·cs·x_p·x_q + 2·cs·(x_p + x_q)`` (the QUBO form of the Ising
      ``-cs·s_p·s_q``): 0 when the chain agrees, +2·cs per broken edge.
    """
    cs = chain_strength_for(qdict) if chain_strength is None else float(chain_strength)
    phys: dict = {}

    def add(i, j, v):
        k = (i, j) if i <= j else (j, i)
        phys[k] = phys.get(k, 0.0) + v

    for (u, v), val in qdict.items():
        if u == v:
            chain = embedding[u]
            for q in chain:
                add(q, q, val / len(chain))
            continue
        couplers = [(q, p) for q in embedding[u] for p in embedding[v]
                    if p in target_adj.get(q, ())]
        if not couplers:
            if val:
                raise ValueError(
                    f"source edge ({u},{v}) has no physical coupler — embedding "
                    "does not cover this QUBO structure")
            continue
        for q, p in couplers:
            add(q, p, val / len(couplers))
    for var, chain in embedding.items():
        cset = set(chain)
        intra: dict = {q: [] for q in cset}
        for q in chain:
            for p in target_adj.get(q, ()):
                if p in cset and q < p:  # each intra-chain coupler once
                    add(q, p, -4.0 * cs)
                    add(q, q, 2.0 * cs)
                    add(p, p, 2.0 * cs)
                    intra[q].append(p)
                    intra[p].append(q)
        if len(cset) > 1:
            # a chain edge missing from the target (dead coupler) would leave
            # the halves annealing independently with NO penalty holding them
            # together — refuse, mirroring the inter-chain coverage check
            first = next(iter(cset))
            frontier, visited = [first], {first}
            while frontier:
                for p in intra[frontier.pop()]:
                    if p not in visited:
                        visited.add(p)
                        frontier.append(p)
            if visited != cset:
                raise ValueError(
                    f"chain for variable {var} is disconnected on the target "
                    "graph — embedding does not fit this chip")
    for chain in embedding.values():  # keep isolated chain qubits present
        for q in chain:
            phys.setdefault((q, q), 0.0)
    return phys


def unembed_samples(phys: np.ndarray, columns_of, embedding: dict,
                    n_vars: int | None = None):
    """(reads, n_phys) physical samples → (reads, n_vars) logical samples by
    per-chain MAJORITY VOTE (the ``unembed_sampleset`` role,
    ``src/model/faster_dqbm.py:370``; ties round UP).

    ``columns_of`` maps a qubit id to its column in ``phys``.  Returns
    ``(logical, chain_break_fraction)`` where the fraction counts
    (read, var) cells whose chain disagreed internally."""
    n_vars = len(embedding) if n_vars is None else n_vars
    reads = phys.shape[0]
    out = np.zeros((reads, n_vars), dtype=np.float32)
    broken = 0
    for v, chain in embedding.items():
        cols = [columns_of[q] for q in chain]
        votes = phys[:, cols]
        mean = votes.mean(axis=1)
        out[:, v] = (mean >= 0.5).astype(np.float32)
        broken += int(((mean != 0.0) & (mean != 1.0)).sum())
    frac = broken / float(max(reads * n_vars, 1))
    return out, frac


# ---------------------------------------------------------------------------
# cache


class EmbeddingCache:
    """Compute-once-per-structure embedding store: memory first, then an
    optional on-disk pickle directory (the reference persists
    ``embeddings_{clamped,unclamped}_<H>.pkl`` per hidden-node count and
    loads them at model init, ``src/model/faster_dqbm.py:152-165``)."""

    def __init__(self, cache_dir: str | Path | None = None):
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self._mem: dict = {}
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.cache_dir / f"embeddings_{key}.pkl"

    def get(self, key: str):
        if key in self._mem:
            return self._mem[key]
        if self.cache_dir:
            p = self._path(key)
            if p.exists():
                with open(p, "rb") as f:
                    value = pickle.load(f)
                self._mem[key] = value
                return value
        return None

    def put(self, key: str, value) -> None:
        self._mem[key] = value
        if self.cache_dir:
            with open(self._path(key), "wb") as f:
                pickle.dump(value, f)
