"""KV-page migration: serializable page bundles for disaggregated serving.

The port's copy of ``deepspeed_tpu/inference/migration.py``, free of any
framework there already: the wire form (meta keys, chunk framing, crc32,
``kv_dtype`` names, page bytes ``[L, 2, KV, block_size, D]`` in C order) is
the JAX package's byte for byte, so bundles cross between the packages.

Splitwise (ISCA'24) and DistServe (OSDI'24) split prefill and decode onto
separate pools and ship the prompt's KV cache between them. This module is
the transfer half of that primitive for the paged pool: a sequence's
computed KV — page-aligned full pages plus the partial tail extent — and
the metadata needed to resume it elsewhere (token chain, computed/generated
counters, prefix-cache chain hashes, quant-scale sidecar) packed into a
:class:`PageBundle` that serializes over the line-JSON serving protocol.

Ownership and rollback live in :class:`~.ragged.StateManager`'s refcounted
migration API (``migrate_out`` / ``export_ack`` / ``export_abort`` /
``migrate_in_begin`` / ``import_commit`` / ``abort_import`` — the AST lint
``bin/check_state_invariants.py`` pins every page-ownership mutation to
it). This module owns only the WIRE form:

- :func:`iter_chunks` slices a bundle's payload into bounded
  self-describing chunks (page index, intra-page offset, crc32) so the
  transfer rides the existing deadline-bounded ``LineChannel`` protocol
  one small message at a time — resumable per-chunk: a receiver that
  observes a gap after EOF names the missing chunk ids and the sender
  (the router, which buffers the bundle) resends exactly those.
- :class:`BundleAssembler` is the receive side: collects chunks in any
  order, verifies each crc, reports gaps, and reassembles the payload.

Transport is host-bounce (device pages -> pinned host bytes -> peer pool);
the bundle layout is transport-agnostic, so a device-to-device path can
replace the byte payload without touching the ownership story.
"""
from __future__ import annotations

import base64
import hashlib
import struct
import zlib
from dataclasses import dataclass, field

from .prefix_cache import chain_hashes

#: default max raw payload bytes per wire chunk: small enough that one
#: chunk never monopolizes a poll tick or a pipe buffer, large enough
#: that a typical page is one chunk
CHUNK_BYTES = 256 * 1024


class MigrationError(RuntimeError):
    """A bundle failed validation (bad crc, gap, meta mismatch)."""


@dataclass
class PageBundle:
    """One sequence's migratable state: metadata + per-page KV payload.

    ``pages[j]`` holds page ``j`` of ``tokens`` (``block_size`` tokens of
    KV, serialized); ``tail`` holds the partial extent ``tail_rows``
    tokens of KV past the last full page — together exactly the
    ``n_computed`` committed-KV tokens, so the importer resumes with a
    plain decode step (bit-identical continuation; nothing is
    recomputed). ``chain`` carries the prefix-cache chain hashes of the
    full pages: the importer seeds its radix trie with them
    (cross-replica radix cache) and the router places the bundle on the
    replica already holding the deepest chain."""
    trace_id: str
    tokens: list[int]
    prompt_len: int
    n_computed: int
    n_generated: int
    max_new_tokens: int
    eos_id: int | None
    tenant: str
    block_size: int
    kv_dtype: str                       # pool dtype name; "toy" = synthetic
    page_bytes: int                     # serialized size of one full page
    tail_rows: int
    tail_bytes: int
    #: "seq" = a live sequence's migratable state (disaggregated
    #: handoff / rebalance: resumes decoding on the importer); "prefix" =
    #: a bare cached page chain (placement-time radix pull: the importer
    #: seeds its trie and the arriving request prefills from it — no
    #: sequence exists, so every token is computed and page-aligned).
    #: Gang prefill's member-to-member KV hops (``serving/router.py``)
    #: ride ``"prefix"`` too: each hop bundles the merged chain so far,
    #: and ``chain`` carries the full-prompt chain hashes so the next
    #: member's radix match skips exactly the adopted pages — the merge
    #: is bit-identical by construction, no new wire form needed.
    kind: str = "seq"
    #: the weight version the pages were computed under —
    #: ``{"id": monotonic int, "digest": manifest digest}`` — stamped at
    #: export and checked at import: KV computed under one set of weights
    #: must never seed a pool serving another (the rolling-deploy
    #: version-skew guard; ``None`` = pre-versioning bundle, matches only
    #: a peer that also reports no version)
    weight_version: dict | None = None
    chain: list[int] = field(default_factory=list)
    #: per-page quant-scale sidecar. The engine's fp8-KV pool is
    #: scale-free (e4m3 covers K/V activations), so this is None there;
    #: pools that carry side-car scales ship them here, one blob per page.
    scales: list[str] | None = None
    pages: list[bytes] = field(default_factory=list)
    tail: bytes | None = None

    @property
    def n_full(self) -> int:
        return self.n_computed // self.block_size

    @property
    def payload_bytes(self) -> int:
        return sum(len(p) for p in self.pages) + len(self.tail or b"")

    def validate(self) -> None:
        if not self.tokens:
            raise MigrationError("empty token chain")
        if self.kind == "prefix":
            # a pulled chain is exactly N cached full pages: no tail, no
            # generation state, every token's KV present
            if self.n_computed != len(self.tokens) \
                    or self.n_computed % self.block_size \
                    or self.tail_rows or self.n_generated:
                raise MigrationError(
                    f"prefix bundle must be whole full pages "
                    f"(n_computed {self.n_computed}, tokens "
                    f"{len(self.tokens)}, tail {self.tail_rows}, "
                    f"generated {self.n_generated})")
        elif not 0 <= self.n_computed <= len(self.tokens) - 1:
            raise MigrationError(
                f"n_computed {self.n_computed} outside "
                f"[0, {len(self.tokens) - 1}]")
        if self.kind != "prefix" \
                and self.n_generated != len(self.tokens) - self.prompt_len:
            raise MigrationError(
                f"token chain of {len(self.tokens)} disagrees with "
                f"prompt {self.prompt_len} + generated {self.n_generated}")
        if len(self.pages) != self.n_full:
            raise MigrationError(f"{len(self.pages)} pages for "
                                 f"{self.n_full} full-page extents")
        if any(len(p) != self.page_bytes for p in self.pages):
            raise MigrationError("page payload size drift")
        if self.tail_rows and (self.tail is None
                               or len(self.tail) != self.tail_bytes):
            raise MigrationError("partial tail extent missing or torn")
        want = chain_hashes(self.tokens[:self.n_full * self.block_size],
                            self.block_size)
        if self.chain != want:
            raise MigrationError("chain hashes disagree with the token "
                                 "chain (corrupt meta)")

    # -- wire form --------------------------------------------------------
    def meta(self) -> dict:
        """The payload-free wire header (rides the handoff message)."""
        return {"id": self.trace_id, "tok": list(self.tokens),
                "plen": self.prompt_len, "nc": self.n_computed,
                "ng": self.n_generated, "max_new": self.max_new_tokens,
                "eos": self.eos_id, "tenant": self.tenant,
                "bs": self.block_size, "dtype": self.kv_dtype,
                "page_bytes": self.page_bytes,
                "tail_rows": self.tail_rows, "tail_bytes": self.tail_bytes,
                "kind": self.kind, "wv": self.weight_version,
                "chain": list(self.chain), "scales": self.scales}

    @classmethod
    def from_meta(cls, meta: dict) -> "PageBundle":
        """Payload-less shell from a wire header (the receive side fills
        pages/tail via :class:`BundleAssembler`)."""
        return cls(trace_id=str(meta["id"]),
                   tokens=[int(t) for t in meta["tok"]],
                   prompt_len=int(meta["plen"]),
                   n_computed=int(meta["nc"]),
                   n_generated=int(meta["ng"]),
                   max_new_tokens=int(meta["max_new"]),
                   eos_id=meta.get("eos"),
                   tenant=str(meta.get("tenant", "default")),
                   block_size=int(meta["bs"]),
                   kv_dtype=str(meta["dtype"]),
                   page_bytes=int(meta["page_bytes"]),
                   tail_rows=int(meta["tail_rows"]),
                   tail_bytes=int(meta["tail_bytes"]),
                   kind=str(meta.get("kind", "seq")),
                   weight_version=meta.get("wv"),
                   chain=[int(h) for h in meta["chain"]],
                   scales=meta.get("scales"))

    @classmethod
    def prefix(cls, trace_id: str, tokens: list[int], block_size: int,
               kv_dtype: str, page_bytes: int, pages: list[bytes],
               weight_version: dict | None = None) -> "PageBundle":
        """A bare cached-chain bundle (placement-time radix pull):
        ``tokens`` must be exactly ``len(pages)`` full pages of prompt
        prefix; the importer adopts the pages into its trie unreferenced
        and the pulling request prefills from the cached boundary."""
        chain = chain_hashes(tokens, block_size)
        if len(chain) != len(pages) \
                or len(tokens) != len(pages) * block_size:
            raise MigrationError(
                f"prefix bundle geometry: {len(tokens)} tokens, "
                f"{len(pages)} pages of {block_size}")
        return cls(trace_id=trace_id, tokens=list(tokens),
                   prompt_len=len(tokens), n_computed=len(tokens),
                   n_generated=0, max_new_tokens=0, eos_id=None,
                   tenant="", block_size=block_size, kv_dtype=kv_dtype,
                   page_bytes=page_bytes, tail_rows=0, tail_bytes=0,
                   kind="prefix", weight_version=weight_version,
                   chain=chain, scales=None,
                   pages=list(pages), tail=None)


def version_skew(a: dict | None, b: dict | None) -> bool:
    """True when two weight-version stamps name DIFFERENT weights. A
    ``None`` stamp (pre-versioning bundle or peer) is treated as
    compatible-with-anything: the skew guard exists to stop a transfer
    between replicas KNOWN to run different weights, and refusing legacy
    traffic would turn an upgrade into an outage."""
    return a is not None and b is not None and a != b


def iter_chunks(bundle: PageBundle, max_bytes: int = CHUNK_BYTES,
                encode: bool = True) -> list[dict]:
    """Slice a bundle's payload into self-describing wire chunks:
    ``{"i": chunk id, "p": page index (-1 = tail), "o": offset within the
    page, "n": raw bytes, "crc": crc32, "data": base64}``. Chunk ids are
    dense ``0..len-1`` — the EOF message carries the count and a receiver
    names gaps by id. ``encode=False`` carries the payload as ``"raw"``
    bytes instead of base64 ``"data"`` (NOT wire-ready): the shm
    transport writes the raw bytes straight into its ring and only
    base64s the chunks that fall back to inline, skipping a pointless
    encode+decode pass over every transferred byte."""
    out: list[dict] = []
    payloads = [(j, p) for j, p in enumerate(bundle.pages)]
    if bundle.tail:
        payloads.append((-1, bundle.tail))
    i = 0
    for p, blob in payloads:
        for o in range(0, len(blob), max_bytes):
            raw = blob[o:o + max_bytes]
            c = {"i": i, "p": p, "o": o, "n": len(raw),
                 "crc": zlib.crc32(raw)}
            if encode:
                c["data"] = base64.b64encode(raw).decode("ascii")
            else:
                c["raw"] = raw
            out.append(c)
            i += 1
    return out


class BundleAssembler:
    """Receive side of a chunked bundle transfer: collects chunks in any
    order, rejects corrupt ones (crc), names gaps after EOF, reassembles.
    Duplicate deliveries are idempotent (a resend after a ``mig_need``
    may race the original)."""

    def __init__(self, meta: dict):
        self.bundle = PageBundle.from_meta(meta)
        self._parts: dict[int, tuple[int, int, bytes]] = {}
        self.total: int | None = None
        self.bytes_received = 0

    def add(self, msg: dict) -> None:
        self.add_raw(msg, base64.b64decode(msg["data"]))

    def add_raw(self, msg: dict, raw: bytes) -> None:
        """Ingest a chunk whose payload arrived OUT of band (the
        shared-memory transport: the descriptor rode the line protocol,
        ``raw`` was copied from the exporter's ring). Same crc gate as
        the in-band path — a lapped ring extent can never be adopted."""
        if len(raw) != int(msg["n"]) or zlib.crc32(raw) != int(msg["crc"]):
            raise MigrationError(
                f"chunk {msg.get('i')} failed its crc — torn transfer")
        i = int(msg["i"])
        if i not in self._parts:
            self.bytes_received += len(raw)
        self._parts[i] = (int(msg["p"]), int(msg["o"]), raw)

    def eof(self, total: int) -> None:
        self.total = int(total)

    def missing(self) -> list[int]:
        """Chunk ids not yet received (valid after :meth:`eof`)."""
        if self.total is None:
            raise MigrationError("missing() before eof")
        return sorted(set(range(self.total)) - set(self._parts))

    def assemble(self) -> PageBundle:
        """Reassemble and validate; raises :class:`MigrationError` on any
        gap, size drift, or chain mismatch."""
        if self.total is None or self.missing():
            raise MigrationError(f"assemble with gaps: {self.missing()}")
        b = self.bundle
        pages: dict[int, list[tuple[int, bytes]]] = {}
        for p, o, raw in self._parts.values():
            pages.setdefault(p, []).append((o, raw))
        for p in pages:
            pages[p] = b"".join(r for _, r in sorted(pages[p]))
        b.pages = [pages.get(j, b"") for j in range(b.n_full)]
        b.tail = pages.get(-1) if b.tail_rows else None
        b.validate()
        return b


# -- toy payloads ----------------------------------------------------------
# A serving tier's toy backend has no device pool; its "KV pages" are
# deterministic bytes derived from the page's chain hash, so tests exercise
# the real chunking/crc/resume/abort machinery — and an importer VERIFIES
# payload integrity — without a model.

TOY_PAGE_BYTES = 48


def toy_page_payload(chain_hash: int,
                     page_bytes: int = TOY_PAGE_BYTES) -> bytes:
    h = hashlib.blake2b(struct.pack("<Q", chain_hash & (1 << 64) - 1),
                        digest_size=16)
    blob = h.digest()
    return (blob * (-(-page_bytes // len(blob))))[:page_bytes]


def toy_tail_payload(prefix_hash: int, tail_tokens) -> bytes:
    h = hashlib.blake2b(struct.pack("<Q", prefix_hash & (1 << 64) - 1),
                        digest_size=16)
    for t in tail_tokens:
        h.update(struct.pack("<q", int(t)))
    return h.digest()


def toy_bundle(trace_id: str, prompt: list[int], generated: list[int],
               max_new_tokens: int, eos_id: int | None, tenant: str,
               block_size: int,
               weight_version: dict | None = None) -> PageBundle:
    """Build the toy backend's synthetic-but-verifiable bundle: payloads
    are pure functions of the chain, so the importer re-derives and
    compares them (transfer-integrity oracle)."""
    tokens = list(prompt) + list(generated)
    n_computed = len(tokens) - 1
    n_full = n_computed // block_size
    chain = chain_hashes(tokens[:n_full * block_size], block_size)
    tail_rows = n_computed - n_full * block_size
    tail = toy_tail_payload(chain[-1] if chain else 0,
                            tokens[n_full * block_size:n_computed]) \
        if tail_rows else None
    return PageBundle(
        trace_id=trace_id, tokens=tokens, prompt_len=len(prompt),
        n_computed=n_computed, n_generated=len(generated),
        max_new_tokens=max_new_tokens, eos_id=eos_id, tenant=tenant,
        block_size=block_size, kv_dtype="toy",
        page_bytes=TOY_PAGE_BYTES, tail_rows=tail_rows,
        tail_bytes=len(tail or b""),
        weight_version=weight_version, chain=chain, scales=None,
        pages=[toy_page_payload(h) for h in chain], tail=tail)


def toy_prefix_bundle(trace_id: str, tokens: list[int], block_size: int,
                      weight_version: dict | None = None
                      ) -> PageBundle | None:
    """Prefix-pull export for the toy backend: bundle the full pages of
    ``tokens`` (already truncated to the cached extent by the caller)
    with chain-derived payloads the importer verifies."""
    n_full = len(tokens) // block_size
    if n_full == 0:
        return None
    aligned = tokens[:n_full * block_size]
    chain = chain_hashes(aligned, block_size)
    return PageBundle.prefix(trace_id, aligned, block_size, "toy",
                             TOY_PAGE_BYTES,
                             [toy_page_payload(h) for h in chain],
                             weight_version=weight_version)


def toy_verify(bundle: PageBundle) -> None:
    """The toy importer's integrity oracle: every payload must equal the
    chain-derived expectation (what checksumming the real KV bytes proves
    for the engine path)."""
    bundle.validate()
    for j, h in enumerate(bundle.chain):
        if bundle.pages[j] != toy_page_payload(h, bundle.page_bytes):
            raise MigrationError(f"toy page {j} payload corrupt")
    if bundle.tail_rows:
        want = toy_tail_payload(
            bundle.chain[-1] if bundle.chain else 0,
            bundle.tokens[bundle.n_full * bundle.block_size:
                          bundle.n_computed])
        if bundle.tail != want:
            raise MigrationError("toy tail payload corrupt")
