"""KV tiering, ported (``deepspeed_tpu_torch/inference/kvtier.py``): HBM →
host RAM → NVMe under the radix trie.

- Port copies of ``tests/test_kvtier.py``'s host cases: the bounded RAM
  ring, the segmented NVMe spill (rotation, caps, torn tails found on
  open), version skew after a weight swap, promote-ahead, the two-phase
  extract, the fault points through the port's ``FaultInjector``, and
  eviction under pressure demoting through ``StateManager``.
- Spill segments and tiers written by one package open in the other.
- Engines: eviction demotes through the device gather and a later admit
  promotes through adopt + scatter, with the same stream, counters and
  digests as the JAX engine; the promoted pages are bit for bit the
  demoted ones. A tier failure degrades to eviction without demotion
  (counted); a failed device gather reaches the caller with the trie
  untouched, and is never counted as a tier fallback."""
import os
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kvtier as jkv
from deepspeed_tpu.inference import migration as jmig
from deepspeed_tpu_torch.inference import PrefixCache, StateManager
from deepspeed_tpu_torch.inference.kvtier import (GUESS_NVME_BYTES_S,
                                                  GUESS_RAM_BYTES_S, HostRing,
                                                  KVTier, KVTierConfig,
                                                  KVTierError, NVMeSpill,
                                                  auto_min_pages,
                                                  measure_tier_rates,
                                                  scale_sidecar_encode)
from deepspeed_tpu_torch.inference.migration import (toy_page_payload,
                                                     toy_prefix_bundle,
                                                     toy_verify)
from deepspeed_tpu_torch.inference.prefix_cache import (DemoteError,
                                                        chain_hashes)
from deepspeed_tpu_torch.inference.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    InjectedFault)
from tests.test_torch_migration import (PROMPT, engine, pool_page, serve,
                                        weights)  # noqa: F401

BS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bundle(tokens, wv=None):
    return toy_prefix_bundle("", list(tokens), BS, weight_version=wv)


# ---------------------------------------------------------------------------
# ring / spill units
# ---------------------------------------------------------------------------

def test_host_ring_bounds_bytes_oldest_out():
    ring = HostRing(100)
    assert ring.put(1, {}, b"a" * 48) == [] and ring.bytes == 48
    assert ring.put(2, {}, b"b" * 48) == [] and len(ring) == 2
    spilled = ring.put(3, {}, b"c" * 48)     # over budget: oldest out
    assert [h for h, _, _ in spilled] == [1]
    assert 1 not in ring and 2 in ring and 3 in ring
    ring.put(3, {}, b"d" * 48)               # replacement: no double count
    assert ring.bytes == 96
    assert ring.get(2) is not None           # get() refreshes recency
    assert [h for h, _, _ in ring.put(4, {}, b"e" * 48)] == [3]


def test_spill_roundtrip_rotation_and_total_cap(tmp_path):
    sp = NVMeSpill(str(tmp_path), cap_bytes=4096, segment_bytes=256)
    for i in range(20):
        sp.append(i, {"pb": 48}, bytes([i]) * 48)
    assert len(sp._segments()) > 1
    for h in list(sp.keys()):
        meta, payload = sp.read(h)
        assert payload == bytes([h]) * 48 and meta["pb"] == 48
    for i in range(100, 160):
        sp.append(i, {}, bytes([i % 251]) * 48)
    assert sp.bytes <= 4096 + 256          # bounded (cap + one segment)
    assert sp.evicted_pages > 0
    sp.close()


def test_spill_torn_tail_and_midfile_detected_on_open(tmp_path):
    sp = NVMeSpill(str(tmp_path), cap_bytes=1 << 20, segment_bytes=1 << 20)
    for i in range(4):
        sp.append(i, {}, bytes([i]) * 48)
    sp.append(99, {}, b"T" * 48, tear=True)   # torn mid-file, unindexed
    sp.append(5, {}, bytes([5]) * 48)
    sp.close()
    re1 = NVMeSpill(str(tmp_path), cap_bytes=1 << 20, segment_bytes=1 << 20)
    assert re1.torn_skipped >= 1 and 99 not in re1
    for i in (0, 1, 2, 3, 5):
        assert re1.read(i)[1] == bytes([i]) * 48
    re1.close()
    seg = sorted(f for f in os.listdir(tmp_path) if f.endswith(".seg"))[-1]
    path = os.path.join(tmp_path, seg)
    with open(path, "r+b") as f:                # truncated tail
        f.truncate(os.path.getsize(path) - 7)
    re2 = NVMeSpill(str(tmp_path), cap_bytes=1 << 20, segment_bytes=1 << 20)
    assert re2.torn_skipped >= re1.torn_skipped and len(re2) < 6
    re2.close()
    sp3 = NVMeSpill(str(tmp_path), cap_bytes=1 << 20, segment_bytes=1 << 20)
    victim = next(iter(sp3.keys()))
    seg_id, off, _, plen, _ = sp3._idx[victim]
    with open(sp3._seg_path(seg_id), "r+b") as f:   # corrupt payload
        f.seek(off)
        f.write(b"\xff" * plen)
    assert sp3.read(victim) is None and victim not in sp3
    sp3.close()


# ---------------------------------------------------------------------------
# tier semantics
# ---------------------------------------------------------------------------

def test_tier_demote_promote_roundtrip_and_overflow(tmp_path):
    t = KVTier(KVTierConfig(ram_bytes=1 << 20, nvme_dir=str(tmp_path / "a")))
    b = _bundle(range(4 * BS))
    assert t.absorb(b) == 4 and t.absorb(b) == 0     # dedup
    assert t.probe(b.chain) == 4
    out = t.extract(list(range(4 * BS)) + [7, 8], BS)
    toy_verify(out)
    assert out.pages == b.pages and out.chain == b.chain
    t.close()
    # the ring fits 2 of 4 pages: the DEEPEST spill, the chain promotes
    t = KVTier(KVTierConfig(ram_bytes=100, nvme_dir=str(tmp_path / "b")))
    t.absorb(b)
    assert b.chain[0] in t.ring and b.chain[1] in t.ring
    assert b.chain[2] in t.spill and b.chain[3] in t.spill
    assert t.extract(list(range(4 * BS)), BS).pages == b.pages
    t.close()
    # RAM-only: overflow drops (counted), a shorter prefix still promotes
    t = KVTier(KVTierConfig(ram_bytes=100, nvme_dir=None))
    t.absorb(b)
    assert t.stats()["dropped_pages"] == 2 and t.probe(b.chain) == 2
    toy_verify(t.extract(list(range(4 * BS)), BS))
    t.absorb(_bundle(range(500, 500 + 4 * BS)))
    assert t.ring.bytes <= 100


def test_tier_version_skew_refused_after_weight_swap(tmp_path):
    t = KVTier(KVTierConfig(ram_bytes=1 << 20, nvme_dir=str(tmp_path)))
    t.absorb(_bundle(range(3 * BS), wv={"id": 1, "digest": "aa"}))
    chain = chain_hashes(list(range(3 * BS)), BS)
    t.set_weight_version({"id": 1, "digest": "aa"})
    assert t.probe(chain) == 3
    t.set_weight_version({"id": 2, "digest": "bb"})
    assert t.probe(chain) == 0
    assert t.extract(list(range(3 * BS)), BS) is None
    assert len(t.ring) == 0
    t.close()


def test_nvme_promote_moves_records_and_keeps_root_newest(tmp_path):
    t = KVTier(KVTierConfig(ram_bytes=100, nvme_dir=str(tmp_path)))
    b = _bundle(range(4 * BS))
    t.absorb(b)
    for _ in range(3):
        out = t.extract(list(range(4 * BS)), BS)
        toy_verify(out)
        for h in b.chain:                      # one tier each, never both
            assert (h in t.ring) != (h in t.spill), h
    t.close()
    t = KVTier(KVTierConfig(ram_bytes=4 * 48, nvme_dir=None))
    t.absorb(b)
    t.probe(b.chain)                           # recency-neutral
    assert t.extract(list(range(4 * BS)), BS).n_full == 4
    t.absorb(_bundle(range(700, 700 + 2 * BS)))
    assert b.chain[0] in t.ring and b.chain[3] not in t.ring


def test_version_bumps_when_records_are_lost(tmp_path):
    t = KVTier(KVTierConfig(ram_bytes=100, nvme_dir=None))
    v0 = t.version
    t.absorb(_bundle(range(4 * BS)))
    assert t.stats()["dropped_pages"] == 2 and t.version > v0
    cfg = KVTierConfig(ram_bytes=1 << 20, nvme_dir=str(tmp_path))
    t2 = KVTier(cfg)
    t2.absorb(_bundle(range(3 * BS), wv={"id": 1, "digest": "a"}))
    t2.close(flush=True)
    re = KVTier(cfg)
    assert len(re.ring) == 0 and len(re.spill) == 3
    v = re.version
    re.set_weight_version({"id": 2, "digest": "b"})
    assert re.version > v and re.residency_digest() == []
    re.close()


def test_close_flush_reopens_warm_and_prefetch_stages(tmp_path):
    cfg = KVTierConfig(ram_bytes=1 << 20, nvme_dir=str(tmp_path))
    t = KVTier(cfg)
    b = _bundle(range(8 * BS))
    t.absorb(b)
    t.close(flush=True)                        # everything on NVMe
    t = KVTier(cfg)
    assert len(t.ring) == 0 and t.probe(b.chain) == 8
    assert t.prefetch(b.chain) == 8
    for h in b.chain:                          # moved, never copied
        assert h in t.ring and h not in t.spill
    reads = []
    orig = t.spill.read
    t.spill.read = lambda h: reads.append(h) or orig(h)
    out = t.extract(list(range(8 * BS)), BS)
    assert out.pages == b.pages and reads == []
    assert t.prefetch(b.chain) == 0
    t.close()
    t = KVTier(cfg)
    t.set_weight_version({"id": 2, "digest": "b"})
    t2 = KVTier(KVTierConfig(ram_bytes=1 << 20))
    t2.absorb(_bundle(range(2 * BS)))
    assert t2.prefetch(chain_hashes(list(range(2 * BS)), BS)) == 0
    assert t2.prefetch(chain_hashes(list(range(500, 500 + 2 * BS)),
                                    BS)) == 0
    t.close()


def test_two_phase_extract_matches_one_shot_and_abandon_is_free(tmp_path):
    tokens = list(range(3 * BS))
    t = KVTier(KVTierConfig(ram_bytes=1 << 20, nvme_dir=str(tmp_path)))
    assert t.absorb(_bundle(tokens)) == 3
    before = t.stats()
    h = t.extract_begin(tokens + [7, 8], BS)
    assert h is not None and h["planned"] == 3
    assert t.stats() == before                 # phase one moved nothing
    b2 = t.extract_finish(t.extract_begin(tokens + [7, 8], BS))
    toy_verify(b2)
    one = t.extract(tokens + [7, 8], BS)
    assert one.pages == b2.pages and one.chain == b2.chain
    ram = t.stats()["ram_bytes"]
    t.close()
    t2 = KVTier(KVTierConfig(ram_bytes=ram, nvme_dir=None))
    assert t2.absorb(_bundle(tokens)) == 3
    h2 = t2.extract_begin(tokens, BS)
    t2.absorb(_bundle(range(500, 500 + 3 * BS)))
    assert t2.extract_finish(h2) is None and t2.extract_finish(None) is None


def test_fault_points_through_the_port_injector(tmp_path):
    cfg = KVTierConfig(ram_bytes=64, nvme_dir=str(tmp_path))
    inj = FaultInjector(spec={"tier_torn_spill": 1}, env="", hard=False)
    t = KVTier(cfg, inj=inj)
    b = _bundle(range(4 * BS))
    t.absorb(b)
    assert t.probe(b.chain) < 4
    out = t.extract(list(range(4 * BS)), BS)
    if out is not None:
        toy_verify(out)
    t.close(flush=True)
    re = KVTier(cfg)
    assert re.spill.torn_skipped >= 1 and re.probe(b.chain) < 4
    re.close()
    inj = FaultInjector(spec={"tier_crash_mid_demote": 1}, env="",
                        hard=False)
    with pytest.raises(InjectedFault):
        KVTier(KVTierConfig(ram_bytes=1 << 20), inj=inj).absorb(
            _bundle(range(2 * BS)))


def test_rates_min_pages_and_sidecar(tmp_path):
    r = measure_tier_rates(str(tmp_path), size_bytes=1 << 20)
    assert r["ram_bytes_s"] > 0 and r["nvme_bytes_s"] > 0 and r["probed"]
    assert measure_tier_rates(None, size_bytes=1 << 20)["nvme_bytes_s"] \
        == GUESS_NVME_BYTES_S
    assert GUESS_RAM_BYTES_S > GUESS_NVME_BYTES_S
    kw = dict(page_bytes=1 << 16, block_size=64, prefill_tok_s=2000.0,
              fixed_s=1e-2)
    for rates, over in [({"ram_bytes_s": 1e9}, {}),
                        ({"ram_bytes_s": 2.2e6}, {}),
                        ({"ram_bytes_s": 1e9, "nvme_bytes_s": 2.2e6},
                         {"nvme": True}),
                        ({"ram_bytes_s": 1e3}, {}), ({}, {}),
                        ({"ram_bytes_s": 1e3}, {"cap": 7})]:
        assert auto_min_pages(rates, **kw, **over) == \
            jkv.auto_min_pages(rates, **kw, **over)
    t = KVTier(KVTierConfig(ram_bytes=1 << 20, min_pages=2))
    for _ in range(16):
        t.note_promote_latency(0.5, pages=1)
    assert t.refine_min_pages(block_size=16, cap=64) == 64
    for _ in range(4000):
        t.note_promote_latency(1e-5, pages=4)
    assert 1 <= t.refine_min_pages(block_size=16, cap=64) < 64
    assert scale_sidecar_encode(b"\x01\x02") == \
        jkv.scale_sidecar_encode(b"\x01\x02")
    assert toy_page_payload(7) != toy_page_payload(8)


# ---------------------------------------------------------------------------
# the packages read each other's spills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(jkv, "port"), ("port", jkv)])
def test_spill_segments_open_in_the_other_package(tmp_path, writer, reader):
    mods = {"port": __import__("deepspeed_tpu_torch.inference.kvtier",
                               fromlist=["x"])}
    w = mods.get(writer, writer)
    r = mods.get(reader, reader)
    sp = w.NVMeSpill(str(tmp_path / "w"), 1 << 20, 512)
    twin = (jkv if w is not jkv else mods["port"]).NVMeSpill(
        str(tmp_path / "twin"), 1 << 20, 512)
    for s in (sp, twin):
        for i in range(12):
            s.append(1000 + i, {"pb": 48, "wv": {"id": 1, "digest": "d"}},
                     bytes([i]) * 48)
        s.append(77, {}, b"T" * 48, tear=True)
        s.append(78, {"pb": 48}, b"z" * 48)
        s.close()
    # the segment files are byte for byte those of the other package
    for f in sorted(os.listdir(tmp_path / "w")):
        assert (tmp_path / "w" / f).read_bytes() == \
            (tmp_path / "twin" / f).read_bytes(), f
    re = r.NVMeSpill(str(tmp_path / "w"), 1 << 20, 512)
    assert sorted(re.keys()) == sorted([*range(1000, 1012), 78])
    assert re.torn_skipped == 1 and 77 not in re
    for i in range(12):
        meta, payload = re.read(1000 + i)
        assert payload == bytes([i]) * 48 and meta["wv"]["id"] == 1
    re.close()
    # a whole tier, flushed by the writer, reopens warm in the reader
    tb = (jmig if w is jkv else
          __import__("deepspeed_tpu_torch.inference.migration",
                     fromlist=["x"])).toy_prefix_bundle(
        "", list(range(4 * BS)), BS)
    cfg = {"ram_bytes": 1 << 20, "nvme_dir": str(tmp_path / "tier")}
    t = w.KVTier(cfg)
    t.absorb(tb)
    t.close(flush=True)
    t2 = r.KVTier(cfg)
    assert t2.probe(tb.chain) == 4
    assert t2.extract(list(range(4 * BS)), BS).pages == tb.pages
    t2.close()


# ---------------------------------------------------------------------------
# pool integration (StateManager)
# ---------------------------------------------------------------------------

def test_eviction_under_pressure_demotes_and_adopt_promotes(tmp_path):
    tier = KVTier(KVTierConfig(ram_bytes=1 << 20, nvme_dir=str(tmp_path)))

    def sink(chains):
        for tokens, _blocks in chains:
            b = toy_prefix_bundle("", tokens, 4)
            if b is not None:
                tier.absorb(b)

    st = StateManager(num_blocks=16, block_size=4, max_seqs=4,
                      max_blocks_per_seq=8)
    st.attach_prefix_cache(PrefixCache(4))
    st.prefix_cache.evict_sink = sink
    sched = SplitFuseScheduler(st, chunk=8, pack=True)
    prompt = list(range(17))                  # 4 full pages + 1
    st.admit(1, prompt, 2)
    while True:
        plan = sched.next_step()
        if plan is None:
            break
        sched.mark_dispatched(plan)
        sched.commit(plan, {u: 900 for u in plan.uids if u >= 0})
        if st.seqs.get(1) is None or st.seqs[1].done:
            break
    st.release(1)
    st.audit()
    assert st.prefix_cache.cached_blocks == 4
    st.admit(2, [500 + i for i in range(9)], 20)
    st.admit(3, [600 + i for i in range(5)], 11)   # evicts: DEMOTES
    st.audit()
    assert tier.stats()["demoted_pages"] >= 1
    st.release(2)
    st.release(3)
    deep = tier.probe(chain_hashes(prompt[:16], 4))
    assert deep >= 1
    bundle = tier.extract(prompt[:deep * 4], 4)
    toy_verify(bundle)
    st.adopt_prefix(bundle.tokens, bundle.n_computed)
    st.audit()
    assert st.prefix_cache.cached_depth(prompt[:16]) >= deep
    tier.close()


def test_sink_failures_tier_degrades_device_raises_flush_never_demotes():
    pc = PrefixCache(4)
    pc.evict_sink = lambda chains: (_ for _ in ()).throw(
        DemoteError("tier full"))
    blocks = iter(range(1, 100))
    pc.publish(list(range(8)), [next(blocks), next(blocks)], 0, 8)
    assert len(pc.evict(2)) == 2              # eviction still reclaims
    assert pc.stats()["demote_errors"] == 1
    # any other failure (a device gather) reaches the caller, trie intact
    pc.publish(list(range(8)), [next(blocks), next(blocks)], 0, 8)
    pc.evict_sink = lambda chains: (_ for _ in ()).throw(
        RuntimeError("device gather failed"))
    v = pc.version
    with pytest.raises(RuntimeError, match="device gather"):
        pc.evict(2)
    assert pc.cached_blocks == 2 and pc.version == v
    assert pc.demote_errors == 1
    hits = []
    st = StateManager(num_blocks=16, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    st.attach_prefix_cache(PrefixCache(4))
    st.prefix_cache.evict_sink = lambda chains: hits.append(chains)
    st.prefix_cache.publish(list(range(8)), st._alloc(2), 0, 8)
    st.flush_prefix_cache()                   # the weight-swap path
    assert hits == []
    st.prefix_cache.publish(list(range(8)), st._alloc(2), 0, 8)
    st.allocator.free(st._alloc(st.allocator.free_blocks
                                + st.prefix_cache.evictable_blocks))
    assert len(hits) == 1
    st.audit()


# ---------------------------------------------------------------------------
# engines: the device half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "fp8"])
def test_engine_demote_promote_matches_the_jax_engine(weights, tmp_path,
                                                      kv):
    """tests/test_kvtier.py's engine leg on both packages' engines, fp32
    and e4m3 pools: the same streams, tier counters and digests; the
    promoted pages are bit for bit the demoted ones."""
    got = {}
    for p in ("port", "jax"):
        eng = engine(weights, p, kv, kv_tier=True, kv_tier_ram_bytes=1 << 20,
                     kv_tier_nvme_dir=str(tmp_path / p))
        base = serve(eng, 1, PROMPT, 6)
        eng.state.audit()
        assert eng._prefix_cache.cached_blocks >= 2
        chain = eng.state.snapshot_prefix(PROMPT)
        eng.state.release_prefix(chain["handle"])
        before = [pool_page(eng, b) for b in chain["blocks"]]
        reclaimed = eng._prefix_cache.evict(len(eng._prefix_cache))
        eng.state.allocator.free(reclaimed)
        eng.state.audit()
        assert eng.stats["kv_tier_demoted_pages"] >= 2
        eng.put(2, PROMPT, max_new_tokens=6)
        assert eng.stats["kv_tier_promotes"] == 1
        seq = eng.state.seqs[2]
        assert seq.prefix_hit_tokens >= 16
        after = [pool_page(eng, b) for b in seq.blocks[:len(before)]]
        assert after == before, "promoted pages differ from the demoted"
        eng.state.audit()
        while not eng.query(2).get("done", False):
            eng.step()
        warm = eng.flush(2)
        eng._kv_tier.set_weight_version({"id": 9, "digest": "other"})
        cold = serve(eng, 3, PROMPT, 6)
        assert eng.stats["kv_tier_promotes"] == 1      # skew: no promote
        eng.state.audit()
        st = eng.kv_tier_stats()
        got[p] = (base, warm, cold, {k: eng.stats[k] for k in (
            "kv_tier_demoted_pages", "kv_tier_promotes",
            "kv_tier_promoted_tokens", "kv_tier_fallbacks")},
            {k: st[k] for k in ("ram_pages", "nvme_pages", "demoted_pages",
                                "promotes", "promoted_pages",
                                "dropped_pages")},
            sorted(eng.kv_tier_digest()), eng.kv_tier_version() > 0)
        assert base == warm == cold
    assert got["port"] == got["jax"]


def test_tier_failure_degrades_and_device_failure_reaches_the_caller(
        weights, tmp_path):
    eng = engine(weights, "port", num_blocks=8, kv_tier=True,
                 kv_tier_ram_bytes=1 << 20, kv_tier_min_pages=1)
    base = serve(eng, 1, PROMPT, 6)           # publishes 3 pages
    assert eng._prefix_cache.cached_blocks == 3
    big = [int(t) for t in np.random.default_rng(1).integers(0, 256, 40)]

    def broken_gather(blocks):
        raise RuntimeError("device gather failed")

    eng._gather_pages = broken_gather
    with pytest.raises(RuntimeError, match="device gather failed"):
        eng.put(2, big, max_new_tokens=10)    # needs all 7 blocks
    assert 2 not in eng.state.seqs
    assert eng._prefix_cache.cached_blocks == 3
    assert eng.stats["kv_tier_fallbacks"] == 0
    assert eng._prefix_cache.demote_errors == 0
    eng.state.audit()
    # a tier failure: eviction proceeds without demotion, counted there
    del eng._gather_pages
    eng._kv_tier.absorb = lambda bundle: (_ for _ in ()).throw(
        KVTierError("tier refused"))
    eng.put(2, big, max_new_tokens=10)
    assert eng._prefix_cache.demote_errors == 1
    assert eng.stats["kv_tier_fallbacks"] == 0
    assert eng.stats["kv_tier_demoted_pages"] == 0
    while not eng.query(2)["done"]:
        eng.step()
    eng.flush(2)
    eng.state.audit()
    del eng._kv_tier.absorb
    assert serve(eng, 3, PROMPT, 6) == base


def test_kv_tier_needs_the_prefix_cache(weights):
    with pytest.raises(ValueError, match="kv_tier requires the shared"):
        engine(weights, "port", prefix_cache=False, kv_tier=True)
    t0 = time.perf_counter()
    eng = engine(weights, "port", kv_tier=True)
    assert eng.kv_tier_stats()["min_pages"] >= 1
    assert time.perf_counter() - t0 < 30
