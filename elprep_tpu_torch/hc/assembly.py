"""De Bruijn read assembly into candidate haplotypes
(reference: filters/assemble-reads.go).

Host-side reimplementation of the reference's kmer graph: graph build
from reads+reference with non-unique-kmer handling (:723-834), low-weight
chain pruning (:629-663), iterative-DFS cycle detection (:440-582),
dangling tail/head recovery with SW merge-back (:1004-1166), conversion
to a sequence graph and simplification (diamond/tail/common-suffix
merges, :1222-1748), and k-best haplotype search over a max-heap of
log-multiplicity path scores (:1741-1896).

Sequences are ``bytes``; vertex ids are increasing ints and all
"get vertices" accessors sort by id, so the whole pipeline is
deterministic (the reference iterates Go maps, which randomizes
tie-order; we produce one fixed member of its outcome set).

This stage is branchy pointer-chasing graph surgery — exactly the code
the SURVEY (§7 hard parts) assigns to the host CPU rather than the TPU;
the downstream PairHMM/SW device kernels consume its haplotypes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import trace
from ..ops import sw

MIN_PRUNING_FACTOR = 2
MAX_CIGAR_COMPLEXITY = 3
MAX_HAPLOTYPES = 128
MIN_HAPLOTYPE_REFERENCE_LENGTH = 30


def _use_native() -> bool:
    """The native graph engine (native/assembly_native.cpp) runs the
    per-kmer-size attempt; this Python module is its oracle. Set
    ELPREP_TPU_NO_NATIVE_ASSEMBLY=1 to force the Python path."""
    import os

    return not os.environ.get("ELPREP_TPU_NO_NATIVE_ASSEMBLY")


@dataclass
class Haplotype:
    bases: bytes
    location: int = 0
    cigar: List[sw.CigOp] = field(default_factory=list)
    is_ref: bool = False
    score: float = math.nan
    # fields used downstream by genotyping
    event_map: Optional[dict] = None


def make_reference_haplotype(bases: bytes, location: int) -> Haplotype:
    return Haplotype(bases=bases, location=location,
                     cigar=[(len(bases), "M")], is_ref=True, score=math.nan)


@dataclass
class Kmer:
    bases: bytes
    start: int
    stop: int
    is_ref: bool = False


class Vertex:
    __slots__ = ("id", "bases")

    def __init__(self, bases: bytes) -> None:
        self.id = 0
        self.bases = bases

    @property
    def suffix(self) -> int:
        return self.bases[-1]

    @property
    def deleted(self) -> bool:
        return self.id == -1


class Edge:
    __slots__ = ("id", "multiplicity", "is_ref")

    def __init__(self, id_: int, multiplicity: int, is_ref: bool) -> None:
        self.id = id_
        self.multiplicity = multiplicity
        self.is_ref = is_ref


class KmerGraph:
    def __init__(self, kmer_size: int) -> None:
        self.vertices_id = 0
        self.kmer_size = kmer_size
        self.vertices: Dict[int, Vertex] = {}
        self.unique_kmers: Dict[bytes, Vertex] = {}
        self.non_unique_kmers: Dict[bytes, bool] = {}
        self.out_edges: Dict[int, List[Edge]] = {}
        self.in_edges: Dict[int, List[Edge]] = {}

    # -- basic accessors ---------------------------------------------------

    def out_degree(self, v: Vertex) -> int:
        return len(self.out_edges.get(v.id, ()))

    def in_degree(self, v: Vertex) -> int:
        return len(self.in_edges.get(v.id, ()))

    def add_vertex(self, v: Vertex) -> None:
        self.vertices_id += 1
        v.id = self.vertices_id
        self.vertices[v.id] = v

    def update_vertex_id(self, v: Vertex) -> None:
        """(assemble-reads.go:139-169) give v the freshest id, rewiring."""
        if v.id == self.vertices_id:
            return
        old = v.id
        self.vertices_id += 1
        new = self.vertices_id
        for incoming in self.in_edges.get(old, ()):
            for outgoing in self.out_edges.get(incoming.id, ()):
                if outgoing.id == old:
                    outgoing.id = new
        for outgoing in self.out_edges.get(old, ()):
            for incoming in self.in_edges.get(outgoing.id, ()):
                if incoming.id == old:
                    incoming.id = new
        if old in self.in_edges:
            self.in_edges[new] = self.in_edges.pop(old)
        if old in self.out_edges:
            self.out_edges[new] = self.out_edges.pop(old)
        v.id = new
        del self.vertices[old]
        self.vertices[new] = v

    def set_out_edges(self, v: Vertex, edges: List[Edge]) -> None:
        if not edges:
            self.out_edges.pop(v.id, None)
        else:
            self.out_edges[v.id] = edges

    def set_in_edges(self, v: Vertex, edges: List[Edge]) -> None:
        if not edges:
            self.in_edges.pop(v.id, None)
        else:
            self.in_edges[v.id] = edges

    def get_out_edge(self, source: Vertex, target: Vertex) -> Optional[Edge]:
        for e in self.out_edges.get(source.id, ()):
            if e.id == target.id:
                return e
        return None

    def add_edge(self, v1: Vertex, v2: Vertex, multiplicity: int,
                 is_ref: bool) -> Tuple[Optional[Edge], Optional[Edge]]:
        if self.get_out_edge(v1, v2) is not None:
            return None, None
        incoming = Edge(v1.id, multiplicity, is_ref)
        self.in_edges.setdefault(v2.id, []).append(incoming)
        outgoing = Edge(v2.id, multiplicity, is_ref)
        self.out_edges.setdefault(v1.id, []).append(outgoing)
        return incoming, outgoing

    def heaviest_out_edge(self, v: Vertex) -> Edge:
        edges = self.out_edges[v.id]
        best = edges[0]
        for e in edges[1:]:
            if e.multiplicity > best.multiplicity:
                best = e
        return best

    def is_singleton(self, v: Vertex) -> bool:
        return self.in_degree(v) == 0 and self.out_degree(v) == 0

    def remove_singleton(self, v: Vertex) -> None:
        if v.id == -1:
            return
        self.vertices.pop(v.id, None)
        if self.unique_kmers.get(v.bases) is v:
            del self.unique_kmers[v.bases]
        v.id = -1

    def remove_edge_raw(self, source: Vertex, target: Vertex) -> None:
        self.set_out_edges(source,
                           [e for e in self.out_edges.get(source.id, ()) if e.id != target.id])
        self.set_in_edges(target,
                          [e for e in self.in_edges.get(target.id, ()) if e.id != source.id])

    def remove_edge(self, source: Vertex, target: Optional[Vertex]) -> None:
        if target is None:
            return
        self.remove_edge_raw(source, target)
        if self.is_singleton(target):
            self.remove_singleton(target)
        if self.is_singleton(source) and len(self.vertices) != 1:
            self.remove_singleton(source)

    def remove_all_out_edges(self, source: Vertex) -> None:
        for e in self.out_edges.get(source.id, ()):
            target = self.vertices[e.id]
            self.set_in_edges(target,
                              [x for x in self.in_edges.get(target.id, ()) if x.id != source.id])
            if self.is_singleton(target):
                self.remove_singleton(target)
        self.out_edges.pop(source.id, None)
        if self.is_singleton(source) and len(self.vertices) != 1:
            self.remove_singleton(source)

    def remove_all_in_edges(self, target: Vertex) -> None:
        for e in self.in_edges.get(target.id, ()):
            source = self.vertices[e.id]
            self.set_out_edges(source,
                               [x for x in self.out_edges.get(source.id, ()) if x.id != target.id])
            if self.is_singleton(source):
                self.remove_singleton(source)
        self.in_edges.pop(target.id, None)
        if self.is_singleton(target) and len(self.vertices) != 1:
            self.remove_singleton(target)

    def remove_vertex(self, v: Vertex) -> None:
        self.remove_all_out_edges(v)
        self.remove_all_in_edges(v)
        self.remove_singleton(v)

    def all_vertices(self) -> List[Vertex]:
        return [self.vertices[k] for k in sorted(self.vertices)]

    def get_vertices(self, predicate) -> List[Vertex]:
        return [v for v in self.all_vertices() if predicate(v)]

    def get_vertex(self, predicate) -> Optional[Vertex]:
        for v in self.all_vertices():
            if predicate(v):
                return v
        return None

    # -- reference topology ------------------------------------------------

    def vertex_is_reference_source(self, v: Vertex) -> bool:
        if len(self.vertices) == 1:
            return True
        for e in self.in_edges.get(v.id, ()):
            if e.is_ref:
                return False
        for e in self.out_edges.get(v.id, ()):
            if e.is_ref:
                return True
        return False

    def vertex_is_reference_sink(self, v: Vertex) -> bool:
        if len(self.vertices) == 1:
            return True
        for e in self.out_edges.get(v.id, ()):
            if e.is_ref:
                return False
        for e in self.in_edges.get(v.id, ()):
            if e.is_ref:
                return True
        return False

    def vertex_is_reference_node(self, v: Vertex) -> bool:
        if len(self.vertices) == 1:
            return True
        for e in self.in_edges.get(v.id, ()):
            if e.is_ref:
                return True
        for e in self.out_edges.get(v.id, ()):
            if e.is_ref:
                return True
        return False

    def is_source_vertex(self, v: Vertex) -> bool:
        return self.in_degree(v) == 0

    def vertex_is_linear_chain_start(self, v: Vertex) -> bool:
        if self.out_degree(v) != 1:
            return False
        if self.in_degree(v) != 1:
            return True
        incoming = self.in_edges[v.id]
        return len(incoming) == 1 and self.out_degree(self.vertices[incoming[0].id]) > 1

    def reference_source(self) -> Optional[Vertex]:
        return self.get_vertex(self.vertex_is_reference_source)

    def reference_sink(self) -> Optional[Vertex]:
        return self.get_vertex(self.vertex_is_reference_sink)

    def non_reference_destinations(self) -> List[Vertex]:
        return self.get_vertices(
            lambda v: self.out_degree(v) == 0 and not self.vertex_is_reference_sink(v))

    def non_reference_starts(self) -> List[Vertex]:
        return self.get_vertices(
            lambda v: self.in_degree(v) == 0 and not self.vertex_is_reference_source(v))

    # -- graph construction (assemble-reads.go:723-834, 1206-1220) ---------

    def determine_non_unique_kmers(self, seq: Kmer) -> None:
        seen = set()
        k = self.kmer_size
        for i in range(0, seq.stop - k + 1):
            km = seq.bases[i : i + k]
            if km in seen:
                self.non_unique_kmers[km] = True
            else:
                seen.add(km)

    def initialize_non_unique_kmers(self, seqs: List[Kmer]) -> None:
        for s in seqs:
            self.determine_non_unique_kmers(s)

    def find_start_of_kmers(self, seq: Kmer) -> int:
        if seq.is_ref:
            return 0
        k = self.kmer_size
        for i in range(seq.start, seq.stop - k):
            if seq.bases[i : i + k] not in self.non_unique_kmers:
                return i
        return -1

    def new_kmer_vertex(self, kmer_seq: bytes) -> Vertex:
        v = Vertex(kmer_seq)
        self.add_vertex(v)
        if kmer_seq not in self.non_unique_kmers and self.unique_kmers.get(kmer_seq) is None:
            self.unique_kmers[kmer_seq] = v
        return v

    def get_kmer_vertex(self, seq: Kmer, start: int) -> Vertex:
        kmer_seq = seq.bases[start : start + self.kmer_size]
        v = self.unique_kmers.get(kmer_seq)
        if v is None:
            v = self.new_kmer_vertex(kmer_seq)
        return v

    def get_kmer_vertex_but_not_ref_source(self, ref_source: bytes, seq: Kmer,
                                           start: int) -> Vertex:
        kmer_seq = seq.bases[start : start + self.kmer_size]
        if kmer_seq == ref_source:
            return self.new_kmer_vertex(kmer_seq)
        v = self.unique_kmers.get(kmer_seq)
        if v is None:
            v = self.new_kmer_vertex(kmer_seq)
        return v

    def increment_out_multiplicity(self, frm: Vertex, to: Vertex) -> None:
        for e in self.out_edges.get(frm.id, ()):
            if e.id == to.id:
                e.multiplicity += 1
                return

    def increment_in_multiplicity(self, frm: Vertex, to: Vertex) -> None:
        for e in self.in_edges.get(to.id, ()):
            if e.id == frm.id:
                e.multiplicity += 1
                return

    def increase_counts_matched_kmers(self, seq: Kmer, original: Vertex) -> None:
        """(assemble-reads.go:787-805)"""

        def recur(vertex: Vertex, offset: int) -> None:
            if offset == -1:
                return
            if self.in_degree(vertex) == 1:
                for e in self.in_edges[vertex.id]:
                    previous = self.vertices[e.id]
                    if previous.suffix == original.bases[offset]:
                        e.multiplicity += 1
                        self.increment_out_multiplicity(previous, vertex)
                        recur(previous, offset - 1)

        recur(original, self.kmer_size - 2)

    def extend_chain_by_one(self, ref_source: bytes, vertex: Vertex, seq: Kmer,
                            i: int) -> Vertex:
        next_pos = i + self.kmer_size - 1
        last_base = seq.bases[next_pos]
        for e in self.out_edges.get(vertex.id, ()):
            connecting = self.vertices[e.id]
            if last_base == connecting.suffix:
                e.multiplicity += 1
                self.increment_in_multiplicity(vertex, connecting)
                return connecting
        new_vertex = self.get_kmer_vertex_but_not_ref_source(ref_source, seq, i)
        self.add_edge(vertex, new_vertex, 1, seq.is_ref)
        return new_vertex

    # -- cycle detection (assemble-reads.go:440-582) ------------------------

    def has_cycle(self) -> bool:
        vertices = self.all_vertices()
        seen: Dict[int, int] = {}
        stack: List[Optional[Vertex]] = []
        path: List[Vertex] = []
        PROCESSING, DONE = 1, 2
        vi = 0

        def encounter(v: Vertex) -> None:
            seen[v.id] = PROCESSING
            stack.append(v)

        def component_exhausted() -> bool:
            while True:
                if not stack:
                    return True
                if stack[-1] is not None:
                    return False
                del stack[-2:]

        if not vertices:
            return False
        encounter(vertices[vi])
        vi += 1
        while True:
            # hasNext
            if component_exhausted():
                advanced = False
                while vi < len(vertices):
                    v = vertices[vi]
                    vi += 1
                    if seen.get(v.id, 0) == 0:
                        encounter(v)
                        advanced = True
                        break
                if not advanced:
                    return False
            # nextVertex
            while True:
                v = stack.pop()
                if v is None:
                    stack.pop()
                else:
                    break
            stack.append(v)
            stack.append(None)
            seen[v.id] = DONE
            i = len(path) - 1
            while i >= 0:
                if any(e.id == v.id for e in self.out_edges.get(path[i].id, ())):
                    break
                path.pop()
                i -= 1
            path.append(v)
            # addNextVertices
            cycle = False
            for e in self.out_edges.get(v.id, ()):
                target = self.vertices[e.id]
                if seen.get(target.id, 0) > 0:
                    if any(p is target for p in path):
                        cycle = True
                        break
                    if seen.get(target.id) == PROCESSING:
                        for i in range(len(stack) - 1, -1, -1):
                            if stack[i] is target:
                                del stack[i]
                                break
                        stack.append(target)
                else:
                    encounter(target)
            if cycle:
                return True

    # -- chains & pruning (assemble-reads.go:584-663) -----------------------

    def find_chain(self, start: Vertex, edge: Edge) -> List[Edge]:
        end = self.vertices[edge.id]
        chain = [Edge(edge.id, edge.multiplicity, edge.is_ref)]
        while True:
            if self.in_degree(end) > 1 or start is end:
                return chain
            end_edges = self.out_edges.get(end.id, ())
            if len(end_edges) != 1:
                return chain
            nxt = end_edges[0]
            chain.append(Edge(nxt.id, nxt.multiplicity, nxt.is_ref))
            end = self.vertices[nxt.id]

    def find_all_chains(self) -> List[Tuple[Vertex, List[Edge]]]:
        sources = self.get_vertices(self.is_source_vertex)
        seen = {v.id for v in sources}
        chains: List[Tuple[Vertex, List[Edge]]] = []
        while sources:
            source = sources.pop()
            for e in self.out_edges.get(source.id, ()):
                chain = self.find_chain(source, e)
                chains.append((source, chain))
                last_id = chain[-1].id
                if last_id not in seen:
                    sources.append(self.vertices[last_id])
                    seen.add(last_id)
        return chains

    def prune_chains_with_low_weight(self) -> None:
        for source, chain in self.find_all_chains():
            if all(e.multiplicity < MIN_PRUNING_FACTOR and not e.is_ref for e in chain):
                s = source
                for e in chain:
                    t = self.vertices[e.id]
                    self.remove_edge_raw(s, t)
                    s = t
                for v in self.all_vertices():
                    if len(self.vertices) == 1:
                        break
                    if self.is_singleton(v):
                        self.remove_singleton(v)

    # -- low complexity (assemble-reads.go:1910-1912) -----------------------

    def is_low_complexity(self) -> bool:
        return len(self.non_unique_kmers) * 4 > len(self.unique_kmers)

    # -- dangling tail/head recovery (assemble-reads.go:896-1166) -----------

    def find_path_upwards_to_lca(self, vertex: Vertex) -> Optional[List[Vertex]]:
        path: List[Vertex] = []
        current = vertex
        while self.in_degree(current) == 1 and self.out_degree(current) < 2:
            edge = self.in_edges[current.id][0]
            target = self.vertices[edge.id]
            if edge.multiplicity < MIN_PRUNING_FACTOR:
                path.clear()
            else:
                path.append(current)
            current = target
        if self.out_degree(current) > 1:
            path.append(current)
            path.reverse()
            return path
        return None

    def find_reference_path(self, path: List[Vertex]) -> List[Vertex]:
        vertex = path[0]
        edges = self.in_edges[path[1].id]
        max_edge: Optional[Edge] = edges[0]
        for e in edges[1:]:
            if e.multiplicity > max_edge.multiplicity:
                max_edge = e
        if max_edge.id == vertex.id:
            max_edge = self.get_out_edge(vertex, path[1])
        else:
            max_edge = None

        out: List[Vertex] = []
        while True:
            out.append(vertex)
            edges = self.out_edges.get(vertex.id, ())
            if not edges:
                return out
            ref_edge = next((e for e in edges if e.is_ref), None)
            if ref_edge is not None:
                vertex = self.vertices[ref_edge.id]
                continue
            if max_edge is None:
                if len(edges) == 1:
                    vertex = self.vertices[edges[0].id]
                    continue
                return out
            next_vertex: Optional[Vertex] = None
            too_many = False
            for e in edges:
                if e is not max_edge:
                    if next_vertex is None:
                        next_vertex = self.vertices[e.id]
                    else:
                        too_many = True
                        break
            if too_many:
                return out
            if next_vertex is not None:
                vertex = next_vertex
                continue
            return out

    @staticmethod
    def path_suffix_bases(path: List[Vertex]) -> bytes:
        return bytes(v.suffix for v in path)

    def path_bases_expanded_sources(self, path: List[Vertex]) -> bytes:
        out = bytearray()
        for v in path:
            if self.is_source_vertex(v):
                out += v.bases[::-1]
            else:
                out.append(v.suffix)
        return bytes(out)

    @staticmethod
    def longest_suffix_match(sequence: bytes, kmer: bytes, start: int) -> int:
        klen = len(kmer)
        for length in range(1, klen + 1):
            seqi = start - length + 1
            if seqi < 0 or sequence[seqi] != kmer[klen - length]:
                return length - 1
        return klen

    def merge_dangling_tail(self, alt_path: List[Vertex], ref_path: List[Vertex],
                            alt_bases: bytes, ref_bases: bytes,
                            cigar: List[sw.CigOp]) -> bool:
        last_ref_index = sw.reference_length(cigar) - 1
        matching_suffix = min(
            self.longest_suffix_match(ref_bases, alt_bases, last_ref_index),
            cigar[-1][0],
        )
        if matching_suffix == 0:
            return False
        alt_index = max(sw.read_length(cigar) - matching_suffix - 1, 0)
        ref_index = last_ref_index - matching_suffix + 1
        if cigar[0][1] == "D" and cigar[0][0] + matching_suffix == last_ref_index + 1:
            ref_index += 1
        if ref_index == 0:
            return False
        self.add_edge(alt_path[alt_index], ref_path[ref_index], 1, False)
        return True

    def recover_dangling_tails(self) -> None:
        for vertex in self.non_reference_destinations():
            alt_path = self.find_path_upwards_to_lca(vertex)
            if alt_path is None or len(alt_path) < 5 or self.vertex_is_reference_source(alt_path[0]):
                continue
            ref_path = self.find_reference_path(alt_path)
            alt_bases = self.path_suffix_bases(alt_path)
            ref_bases = self.path_suffix_bases(ref_path)
            with trace.counting("hc.sw"):
                cigar, _ = sw.run_smith_waterman(ref_bases, alt_bases,
                                                 *sw.ASSEMBLY_SW_PARAMS, sw.LEADING_INDEL)
            if cigar and cigar[-1][1] == "D":
                cigar = cigar[:-1]
            if not cigar or len(cigar) > MAX_CIGAR_COMPLEXITY or cigar[-1][1] != "M":
                continue
            self.merge_dangling_tail(alt_path, ref_path, alt_bases, ref_bases, cigar)

    def find_path_downwards_to_hcd(self, vertex: Vertex) -> Optional[List[Vertex]]:
        path: List[Vertex] = []
        current = vertex
        while not self.vertex_is_reference_node(current) and self.out_degree(current) == 1:
            edge = self.out_edges[current.id][0]
            target = self.vertices[edge.id]
            if edge.multiplicity < MIN_PRUNING_FACTOR:
                path.clear()
            else:
                path.append(current)
            current = target
        if self.vertex_is_reference_node(current):
            path.append(current)
            path.reverse()
            return path
        return None

    def find_reference_path_up(self, path: List[Vertex]) -> List[Vertex]:
        vertex = path[0]
        new_path: List[Vertex] = []
        while True:
            new_path.append(vertex)
            advanced = False
            for e in self.in_edges.get(vertex.id, ()):
                vertex = self.vertices[e.id]
                if self.vertex_is_reference_node(vertex):
                    advanced = True
                    break
            if not advanced:
                return new_path

    @staticmethod
    def best_prefix_match(seq1: bytes, seq2: bytes, max_index: int, kmer_size: int) -> int:
        max_mismatches = max(1, max_index // kmer_size)
        mismatches = 0
        last_good = -1
        for index in range(max_index):
            if seq1[index] != seq2[index]:
                mismatches += 1
                if mismatches > max_mismatches:
                    return -1
                last_good = index
        return last_good

    def extend_path_against_reference(self, alt_path: List[Vertex],
                                      ref_path: List[Vertex],
                                      n_nodes: int, kmer_size: int
                                      ) -> Tuple[List[Vertex], bool]:
        index_last = len(alt_path) - 1
        index_ref = index_last + n_nodes
        if index_ref >= len(ref_path):
            return alt_path, False
        dangling_source = alt_path[index_last]
        alt_path = alt_path[:index_last] + alt_path[index_last + 1 :]
        ref_source_seq = ref_path[index_ref].bases
        seq_to_extend = ref_source_seq[:n_nodes] + dangling_source.bases
        source_edge = self.heaviest_out_edge(dangling_source)
        source_target = self.vertices[source_edge.id]
        self.remove_edge(dangling_source, source_target)
        for i in range(n_nodes, 0, -1):
            nv = Vertex(seq_to_extend[i : min(i + kmer_size, len(seq_to_extend))])
            self.add_vertex(nv)
            self.add_edge(nv, source_target, source_edge.multiplicity, False)
            alt_path.append(nv)
            source_target = nv
        return alt_path, True

    def recover_dangling_heads(self, kmer_size: int) -> None:
        for vertex in self.non_reference_starts():
            alt_path = self.find_path_downwards_to_hcd(vertex)
            if alt_path is None or len(alt_path) < 5 or self.vertex_is_reference_sink(alt_path[0]):
                continue
            ref_path = self.find_reference_path_up(alt_path)
            alt_bases = self.path_bases_expanded_sources(alt_path)
            ref_bases = self.path_bases_expanded_sources(ref_path)
            with trace.counting("hc.sw"):
                cigar, _ = sw.run_smith_waterman(ref_bases, alt_bases,
                                                 *sw.ASSEMBLY_SW_PARAMS, sw.LEADING_INDEL)
            if cigar and cigar[-1][1] == "D":
                cigar = cigar[:-1]
            if not cigar or len(cigar) > MAX_CIGAR_COMPLEXITY or cigar[0][1] != "M":
                continue
            index_to_merge = self.best_prefix_match(ref_bases, alt_bases,
                                                    cigar[0][0], kmer_size)
            if index_to_merge <= 0 or index_to_merge >= len(ref_path) - 1:
                continue
            if index_to_merge >= len(alt_path):
                alt_path, extended = self.extend_path_against_reference(
                    alt_path, ref_path, index_to_merge - len(alt_path) + 2, kmer_size)
                if not extended:
                    continue
            self.add_edge(ref_path[index_to_merge + 1], alt_path[index_to_merge], 1, False)

    # -- connectivity cleanups (assemble-reads.go:1168-1254) ----------------

    def remove_paths_not_connected_to_reference(self) -> None:
        ref_source = self.reference_source()
        from_source: set = set()
        stack = [ref_source]
        while stack:
            v = stack.pop()
            if v.id in from_source:
                continue
            from_source.add(v.id)
            for e in self.out_edges.get(v.id, ()):
                stack.append(self.vertices[e.id])
        ref_sink = self.reference_sink()
        from_sink: set = set()
        stack = [ref_sink]
        while stack:
            v = stack.pop()
            if v.id in from_sink:
                continue
            from_sink.add(v.id)
            for e in self.in_edges.get(v.id, ()):
                stack.append(self.vertices[e.id])
        for v in self.all_vertices():
            if not (v.id in from_source and v.id in from_sink):
                self.remove_vertex(v)

    def convert_to_sequence_graph(self) -> None:
        for v in self.all_vertices():
            if not self.is_source_vertex(v):
                v.bases = bytes([v.suffix])

    def remove_non_reference_components(self) -> None:
        ref_source = self.reference_source()
        visited: set = set()
        stack = [ref_source]
        while stack:
            v = stack.pop()
            if v.id in visited:
                continue
            visited.add(v.id)
            for e in self.in_edges.get(v.id, ()):
                stack.append(self.vertices[e.id])
            for e in self.out_edges.get(v.id, ()):
                stack.append(self.vertices[e.id])
        for v in self.all_vertices():
            if v.id not in visited:
                self.remove_vertex(v)

    # -- simplification (assemble-reads.go:1256-1748) -----------------------

    def merge_out_edges_of(self, v1: Vertex, v2: Vertex) -> None:
        edges2 = self.out_edges.get(v2.id, [])
        for e in edges2:
            incoming = self.in_edges[e.id]
            for i, ie in enumerate(incoming):
                if ie.id == v2.id:
                    ie.id = v1.id
                    self.in_edges[e.id] = incoming[:i] + incoming[i + 1 :] + [ie]
                    break
        for e in self.in_edges.get(v1.id, ()):
            outgoing = self.out_edges[e.id]
            for i, oe in enumerate(outgoing):
                if oe.id == v1.id:
                    self.out_edges[e.id] = outgoing[:i] + outgoing[i + 1 :] + [oe]
                    break
        self.set_out_edges(v1, edges2)
        self.out_edges.pop(v2.id, None)
        self.in_edges.pop(v2.id, None)
        self.remove_singleton(v2)

    def merge_vertices(self, v1: Vertex, v2: Vertex) -> None:
        v1.bases = v1.bases + v2.bases
        self.merge_out_edges_of(v1, v2)
        self.update_vertex_id(v1)

    def merge_linear_chains(self) -> bool:
        modified = False
        for vertex in self.all_vertices():
            if vertex.deleted or not self.vertex_is_linear_chain_start(vertex):
                continue
            prev_is_ref = self.vertex_is_reference_node(vertex)
            while True:
                edges = self.out_edges.get(vertex.id, ())
                if len(edges) != 1:
                    break
                next_vertex = self.vertices[edges[0].id]
                if (vertex is next_vertex
                        or self.in_degree(next_vertex) != 1
                        or prev_is_ref != self.vertex_is_reference_node(next_vertex)):
                    break
                modified = True
                self.merge_vertices(vertex, next_vertex)
            # NB: prev_is_ref evaluated once, as in the reference loop
        return modified

    @staticmethod
    def _common_prefix_suffix(vertices: List[Vertex]) -> Tuple[bytes, bytes]:
        mn = min(len(v.bases) for v in vertices)
        plen = 0
        for i in range(mn):
            c = vertices[0].bases[i]
            if any(v.bases[i] != c for v in vertices[1:]):
                break
            plen += 1
        slen = 0
        for i in range(1, mn - plen + 1):
            c = vertices[0].bases[-i]
            if any(v.bases[-i] != c for v in vertices[1:]):
                break
            slen += 1
        seq = vertices[0].bases
        return seq[:plen], seq[len(seq) - slen :] if slen else b""

    @staticmethod
    def _without_prefix_suffix(seq: bytes, plen: int, slen: int) -> bytes:
        if len(seq) - plen - slen <= 0:
            return b""
        return seq[plen : len(seq) - slen]

    def _detach_top(self, top: Vertex, prefix: bytes) -> Vertex:
        """Create the prefix vertex below top (diamond/tail merge)."""
        prefix_vertex = Vertex(prefix)
        self.add_vertex(prefix_vertex)
        any_ref = False
        for oe in self.out_edges.get(top.id, ()):
            if oe.is_ref:
                any_ref = True
            for ie in self.in_edges.get(oe.id, ()):
                if ie.id == top.id:
                    ie.id = prefix_vertex.id
        self.out_edges[prefix_vertex.id] = self.out_edges.pop(top.id, [])
        self.add_edge(top, prefix_vertex, 1, any_ref)
        return prefix_vertex

    def merge_diamond(self, vertex: Vertex) -> bool:
        middles = [self.vertices[e.id] for e in self.out_edges.get(vertex.id, ())]
        if len(middles) <= 1:
            return False
        bottom: Optional[Vertex] = None
        for middle in middles:
            if self.out_degree(middle) < 1 or self.in_degree(middle) != 1:
                return False
            for e in self.out_edges[middle.id]:
                target = self.vertices[e.id]
                if bottom is None:
                    bottom = target
                elif bottom is not target:
                    return False
        if len(self.in_edges.get(bottom.id, ())) != len(middles):
            return False
        return self._merge_diamond_sequences(vertex, bottom, middles)

    def _merge_diamond_sequences(self, top: Vertex, bottom: Vertex,
                                 middles: List[Vertex]) -> bool:
        prefix, suffix = self._common_prefix_suffix(middles)
        if not prefix and not suffix:
            return False
        for middle in middles:
            self.update_vertex_id(middle)
        prefix_vertex = top
        if prefix:
            prefix_vertex = self._detach_top(top, prefix)
        suffix_vertex = bottom
        if suffix:
            suffix_vertex = Vertex(suffix)
            self.add_vertex(suffix_vertex)
            any_ref = False
            for ie in self.in_edges.get(bottom.id, ()):
                if ie.is_ref:
                    any_ref = True
                for oe in self.out_edges.get(ie.id, ()):
                    if oe.id == bottom.id:
                        oe.id = suffix_vertex.id
            self.in_edges[suffix_vertex.id] = self.in_edges.pop(bottom.id, [])
            self.add_edge(suffix_vertex, bottom, 1, any_ref)

        new_incoming: List[Edge] = []
        new_outgoing: List[Edge] = []
        direct_in: Optional[Edge] = None
        direct_out: Optional[Edge] = None
        for e in list(self.out_edges.get(prefix_vertex.id, ())):
            middle = self.vertices[e.id]
            remaining = self._without_prefix_suffix(middle.bases, len(prefix), len(suffix))
            if remaining:
                middle.bases = remaining
                new_outgoing.append(e)
            else:
                incoming = self.in_edges[middle.id][0]
                outgoing = self.out_edges[middle.id][0]
                mult = incoming.multiplicity + outgoing.multiplicity
                is_ref = incoming.is_ref or outgoing.is_ref
                if direct_out is None:
                    direct_in, direct_out = self.add_edge(prefix_vertex, suffix_vertex,
                                                          mult, is_ref)
                    new_incoming.append(direct_in)
                    new_outgoing.append(direct_out)
                else:
                    direct_in.multiplicity += mult
                    direct_out.multiplicity += mult
                    if is_ref:
                        direct_in.is_ref = True
                        direct_out.is_ref = True
                self.in_edges.pop(middle.id, None)
                self.out_edges.pop(middle.id, None)
                self.vertices.pop(middle.id, None)
                middle.id = -1
        for e in self.in_edges.get(suffix_vertex.id, ()):
            middle = self.vertices.get(e.id)
            if middle is not None and middle.id != prefix_vertex.id:
                new_incoming.append(e)
        self.out_edges[prefix_vertex.id] = new_outgoing
        self.in_edges[suffix_vertex.id] = new_incoming
        return True

    def merge_diamonds(self) -> bool:
        merged = False
        found = True
        while found:
            found = False
            for v in self.all_vertices():
                if v.id != -1 and self.merge_diamond(v):
                    merged = True
                    found = True
                    break
        return merged

    def merge_tail(self, vertex: Vertex) -> bool:
        tails = [self.vertices[e.id] for e in self.out_edges.get(vertex.id, ())]
        if len(tails) <= 1:
            return False
        for t in tails:
            if self.out_degree(t) != 0 or self.in_degree(t) > 1:
                return False
        prefix, suffix = self._common_prefix_suffix(tails)
        if len(suffix) < 10:
            return False
        prefix_vertex = vertex
        if prefix:
            prefix_vertex = self._detach_top(vertex, prefix)
        suffix_vertex = Vertex(suffix)
        self.add_vertex(suffix_vertex)
        multiplicity = 0
        any_ref = False
        for tail in tails:
            remaining = self._without_prefix_suffix(tail.bases, len(prefix), len(suffix))
            if remaining:
                tail.bases = remaining
            else:
                incoming = self.in_edges[tail.id][0]
                if incoming.is_ref:
                    any_ref = True
                multiplicity += incoming.multiplicity
                self.remove_edge(prefix_vertex, tail)
        if multiplicity > 0:
            self.add_edge(prefix_vertex, suffix_vertex, multiplicity, any_ref)
        return True

    def merge_tails(self) -> bool:
        merged = False
        found = True
        while found:
            found = False
            for v in self.all_vertices():
                if v.id != -1 and self.merge_tail(v):
                    merged = True
                    found = True
                    break
        return merged

    def _safe_to_split(self, bottom: Vertex, tops: List[Vertex]) -> bool:
        bottom_connections = self.out_edges.get(bottom.id, ())
        for top in tops:
            if top.id == bottom.id:
                return False
            middle_edges = self.out_edges.get(top.id, ())
            if len(middle_edges) != 1 or middle_edges[0].id != bottom.id:
                return False
            for e in bottom_connections:
                if e.id == top.id:
                    return False
        return True

    def _common_suffix(self, vertex: Vertex, tops: List[Vertex]) -> Optional[bytes]:
        if len(tops) < 2 or not self._safe_to_split(vertex, tops):
            return None
        mn = min(len(v.bases) for v in tops)
        slen = 0
        for i in range(1, mn + 1):
            c = tops[0].bases[-i]
            if any(t.bases[-i] != c for t in tops[1:]):
                break
            slen += 1
        if slen == 0:
            return None
        suffix = tops[0].bases[len(tops[0].bases) - slen :]
        ref_source = next((t for t in tops if self.vertex_is_reference_source(t)), None)
        if ref_source is not None and len(ref_source.bases) == len(suffix):
            return None
        if all(len(t.bases) == len(suffix) for t in tops):
            return None
        return suffix

    def split_common_suffixes_of_vertex(self, vertex: Vertex) -> bool:
        incoming_edges = self.in_edges.get(vertex.id, ())
        tops = [self.vertices[e.id] for e in incoming_edges]
        suffix = self._common_suffix(vertex, tops)
        if suffix is None:
            return False
        for top_edge in list(incoming_edges):
            top = self.vertices[top_edge.id]
            out = self.out_edges[top.id][0]
            top_multiplicity = top_edge.multiplicity
            suffix_vertex = Vertex(suffix)
            self.add_vertex(suffix_vertex)
            remaining = top.bases[: len(top.bases) - len(suffix)] if len(top.bases) >= len(suffix) else b""
            if not remaining:
                target_vertex = suffix_vertex
            else:
                target_vertex = Vertex(remaining)
                self.add_vertex(target_vertex)
                self.add_edge(target_vertex, suffix_vertex, 1, out.is_ref)
            self.add_edge(suffix_vertex, vertex, top_multiplicity, out.is_ref)
            for e in self.in_edges.get(top.id, ()):
                self.add_edge(self.vertices[e.id], target_vertex, e.multiplicity, e.is_ref)
            self.remove_vertex(top)
        return True

    def split_common_suffixes(self) -> bool:
        split = False
        already: set = set()
        found = True
        while found:
            found = False
            for v in self.all_vertices():
                if v.id != -1 and id(v) not in already:
                    already.add(id(v))
                    if self.split_common_suffixes_of_vertex(v):
                        split = True
                        found = True
                        break
        return split

    def merge_common_sequences(self, bottom: Vertex) -> bool:
        tops = [self.vertices[e.id] for e in self.in_edges.get(bottom.id, ())]
        if not tops:
            return False
        seq = tops[0].bases
        for top in tops:
            if (top.bases != seq or self.out_degree(top) != 1
                    or self.in_degree(top) == 0
                    or self.out_edges[top.id][0].id != bottom.id):
                return False
        bottom.bases = seq + bottom.bases
        self.update_vertex_id(bottom)
        for top in tops:
            for e in self.in_edges.get(top.id, ()):
                self.add_edge(self.vertices[e.id], bottom, e.multiplicity, e.is_ref)
            self.remove_vertex(top)
        for e in self.out_edges.get(bottom.id, ()):
            incoming = self.in_edges[e.id]
            for i, ie in enumerate(incoming):
                if ie.id == bottom.id:
                    self.in_edges[e.id] = incoming[:i] + incoming[i + 1 :] + [ie]
                    break
        return True

    def merge_common_incoming_sequences(self) -> bool:
        merged = False
        found = True
        while found:
            found = False
            for v in self.all_vertices():
                if v.id != -1 and self.merge_common_sequences(v):
                    merged = True
                    found = True
                    break
        return merged

    def simplify_once(self) -> bool:
        modified = False
        if self.merge_diamonds():
            modified = True
        if self.merge_tails():
            modified = True
        if self.split_common_suffixes():
            modified = True
        if self.merge_common_incoming_sequences():
            modified = True
        if self.merge_linear_chains():
            modified = True
        return modified

    def _partial_copy(self):
        vertex_bases = {v.bases for v in self.vertices.values()}
        out_pairs = sorted((i, e.id) for i, es in self.out_edges.items() for e in es)
        in_pairs = sorted((i, e.id) for i, es in self.in_edges.items() for e in es)
        return (len(self.vertices), vertex_bases, out_pairs, in_pairs)

    @staticmethod
    def _partial_equal(a, b) -> bool:
        return a[0] == b[0] and len(a[2]) == len(b[2]) and len(a[3]) == len(b[3]) \
            and a[1] <= b[1] and a[2] == b[2] and a[3] == b[3]

    def simplify(self) -> None:
        self.merge_linear_chains()
        for _ in range(7):
            if not self.simplify_once():
                return
        prev = self._partial_copy()
        for _ in range(7, 101):
            if not self.simplify_once():
                return
            cur = self._partial_copy()
            if self._partial_equal(prev, cur):
                return
            prev = cur

    def clean_sequence_graph(self) -> None:
        self.merge_linear_chains()
        self.remove_non_reference_components()
        self.simplify()
        self.remove_non_reference_components()
        self.simplify()
        if len(self.vertices) == 1:
            vertex = next(iter(self.vertices.values()))
            dummy = Vertex(b"")
            self.add_vertex(dummy)
            self.add_edge(vertex, dummy, 0, True)

    # -- k-best haplotypes (assemble-reads.go:1741-1896) --------------------

    def add_best_haplotypes(self, result: List[Haplotype],
                            reference_haplotype: Haplotype,
                            padded_reference_bases: bytes,
                            region_start: int) -> List[Haplotype]:
        source = self.reference_source()
        sink = self.reference_sink()
        # binary max-heap replicating the reference's sift logic exactly
        pq: List[Tuple[float, List[Vertex], bool]] = []

        def sift_up(k: int, x) -> None:
            while k > 0:
                parent = (k - 1) >> 1
                e = pq[parent]
                if x[0] <= e[0]:
                    break
                pq[k] = e
                k = parent
            pq[k] = x

        def enqueue(x) -> None:
            if not pq:
                pq.append(x)
                return
            pq.append(None)
            sift_up(len(pq) - 1, x)

        def sift_down(k: int, x) -> None:
            half = len(pq) >> 1
            while k < half:
                child = (k << 1) + 1
                c = pq[child]
                right = child + 1
                if right < len(pq) and c[0] < pq[right][0]:
                    child = right
                    c = pq[child]
                if x[0] >= c[0]:
                    break
                pq[k] = c
                k = child
            pq[k] = x

        def dequeue():
            s = len(pq) - 1
            top = pq[0]
            x = pq.pop()
            if s != 0:
                sift_down(0, x)
            return top

        enqueue((0.0, [source], True))
        results = []
        vertex_counts: Dict[int, int] = {}
        while pq and len(results) < MAX_HAPLOTYPES:
            score, vertices, _ = dequeue()
            vertex_to_extend = vertices[-1]
            if vertex_to_extend is sink:
                results.append((score, vertices))
                continue
            count = vertex_counts.get(id(vertex_to_extend), 0)
            vertex_counts[id(vertex_to_extend)] = count + 1
            if count >= MAX_HAPLOTYPES:
                continue
            edges = self.out_edges.get(vertex_to_extend.id, ())
            total = sum(e.multiplicity for e in edges)
            if total <= 0:
                continue
            total_log10 = math.log10(float(total))
            for e in edges:
                ext = score + math.log10(float(e.multiplicity)) - total_log10 \
                    if e.multiplicity > 0 else score + float("-inf")
                enqueue((ext, vertices + [self.vertices[e.id]], False))

        return finish_candidates(
            result, [(score, b"".join(v.bases for v in vertices))
                     for score, vertices in results],
            reference_haplotype, padded_reference_bases, region_start)


def finish_candidates(result: List[Haplotype],
                      candidates: List[Tuple[float, bytes]],
                      reference_haplotype: Haplotype,
                      padded_reference_bases: bytes,
                      region_start: int) -> List[Haplotype]:
    """Dedup + haplotype-vs-reference cigar + filters for k-best
    candidate (score, bases) pairs (the tail of addBestHaplotypes,
    assemble-reads.go:1853-1896). Shared by the Python graph and the
    native engine (native/assembly_native.cpp)."""
    existing = {h.bases for h in result}
    for score, bases in candidates:
        if bases in existing:
            continue
        with trace.counting("hc.sw"):
            cigar = sw.calculate_cigar(reference_haplotype.bases, bases,
                                       padded_reference_bases, sw.SOFTCLIP)
        if not cigar or any(op == "N" for _, op in cigar) \
                or sw.reference_length(cigar) < MIN_HAPLOTYPE_REFERENCE_LENGTH:
            continue
        h = Haplotype(bases=bases, score=score, is_ref=False,
                      cigar=cigar, location=region_start)
        result.append(h)
        existing.add(bases)
    return result


# ---------------------------------------------------------------------------
# Assembly driver (assemble-reads.go:1914-1996)
# ---------------------------------------------------------------------------


def base_useable_for_assembly(base: int, qual: int, min_base_qual: int) -> bool:
    return base != ord("N") and qual >= min_base_qual


def add_sequences_for_kmers(sequences: List[Kmer], seq: bytes, qual: bytes,
                            kmer_size: int, min_base_qual: int) -> List[Kmer]:
    """Usable-base runs of a read (assemble-reads.go:51-77)."""
    start = -1
    end = len(seq)
    for stop in range(end):
        if not base_useable_for_assembly(seq[stop], qual[stop], min_base_qual):
            if start != -1 and stop - start >= kmer_size:
                sequences.append(Kmer(bases=seq, start=start, stop=stop))
            start = -1
        elif start == -1:
            start = stop
    if start != -1 and end - start >= kmer_size:
        sequences.append(Kmer(bases=seq, start=start, stop=end))
    return sequences


def non_unique_kmers_exist(bases: bytes, kmer_size: int) -> bool:
    seen = set()
    for i in range(0, len(bases) - kmer_size + 1):
        km = bases[i : i + kmer_size]
        if km in seen:
            return True
        seen.add(km)
    return False


def assemble_reads(
    reference_bases: bytes,
    padded_start: int,
    reads,  # list of (seq, qual) bytes pairs OR (seq_flat, qual_flat, offs)
    min_base_qual: int = 10,
) -> List[Haplotype]:
    """Assemble reads over a region into haplotypes
    (reference: assembleReads, assemble-reads.go:1914-1996).

    ``reads`` may be the columnar ``(seq_flat, qual_flat, offsets)``
    triple straight from the native finalize — the native engine
    consumes it with zero per-read bytes objects; the Python oracle
    path materializes pairs on demand."""
    padded_reference_bases = sw.SW_PAD + reference_bases + sw.SW_PAD
    reference_haplotype = make_reference_haplotype(reference_bases, padded_start)
    result = [reference_haplotype]

    def materialized():
        nonlocal reads
        if isinstance(reads, tuple):
            seq_c, qual_c, offs = reads
            reads = [(seq_c[offs[k]:offs[k + 1]].tobytes(),
                      qual_c[offs[k]:offs[k + 1]].tobytes())
                     for k in range(len(offs) - 1)]
        return reads

    def process_kmer_size(kmer_size: int, last_attempt: bool) -> bool:
        nonlocal result
        if _use_native():
            from .. import native

            cand = native.assembly_try(reference_bases, reads, kmer_size,
                                       min_base_qual, last_attempt)
            if cand is not None:
                if cand is False:
                    return False
                result = finish_candidates(result, cand, reference_haplotype,
                                           padded_reference_bases, padded_start)
                return True
        if not last_attempt and non_unique_kmers_exist(reference_bases, kmer_size):
            return False
        graph = KmerGraph(kmer_size)
        seqs = [Kmer(bases=reference_bases, start=0, stop=len(reference_bases), is_ref=True)]
        ref_source = reference_bases[:kmer_size]
        for seq, qual in materialized():
            seqs = add_sequences_for_kmers(seqs, seq, qual, kmer_size, min_base_qual)
        graph.initialize_non_unique_kmers(seqs)
        for kmers_seq in seqs:
            unique_start = graph.find_start_of_kmers(kmers_seq)
            if unique_start == -1:
                continue
            vertex = graph.get_kmer_vertex(kmers_seq, unique_start)
            graph.increase_counts_matched_kmers(kmers_seq, vertex)
            for i in range(unique_start + 1, kmers_seq.stop - kmer_size + 1):
                vertex = graph.extend_chain_by_one(ref_source, vertex, kmers_seq, i)
        if not graph.vertices:
            return False
        graph.prune_chains_with_low_weight()
        if not graph.vertices or graph.has_cycle():
            return False
        if not last_attempt and graph.is_low_complexity():
            return False
        graph.recover_dangling_tails()
        graph.recover_dangling_heads(kmer_size)
        graph.remove_paths_not_connected_to_reference()
        graph.convert_to_sequence_graph()
        graph.clean_sequence_graph()
        result = graph.add_best_haplotypes(result, reference_haplotype,
                                           padded_reference_bases, padded_start)
        return True

    graph_seen = False
    for kmer_size in (10, 25):
        if len(reference_bases) < kmer_size:
            return result
        if process_kmer_size(kmer_size, False):
            graph_seen = True
    if graph_seen:
        return result

    kmer_size = 35
    for _attempt in range(1, 6):
        if len(reference_bases) < kmer_size:
            return result
        if process_kmer_size(kmer_size, False):
            return result
        kmer_size += 10
    if len(reference_bases) < kmer_size:
        return result
    process_kmer_size(kmer_size, True)
    return result
