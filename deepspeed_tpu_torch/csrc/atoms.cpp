// Host-side ragged batch-descriptor builder (the reference's
// inference/v2/ragged/csrc/ fast host buffer + atom building role).
// Packs per-sequence token chunks into the fixed-shape StepPlan arrays the
// serving programs consume: token ids, absolute positions, rolling
// KV pool slots, activity masks, block tables, lengths and sampling flags.
// One pass, no Python per-token loop — at high request rates the batch
// build sits on the serving critical path between device steps.
//
// Layout contract (mirrors inference/scheduler.py::_python_build exactly;
// the Python packer is the plain version the tests hold this one against —
// the serving path packs every plan here):
//   entry_meta per entry: [slot, n, start_pos, sample, n_blocks,
//                          tok_off, blk_off]
//   tokens:  concatenated int32 token chunks (entry i at tok_off, len n)
//   blocks:  concatenated int32 block lists (entry i at blk_off, n_blocks)
// Output arrays are caller-zeroed ([S,T] flattened row-major).

#include <cstdint>

extern "C" {

// Returns 0 on success; 1 + e on the first entry whose metadata violates
// the plan-shape invariants (the caller raises, matching the Python
// packer's loud shape errors — no write happens past a row).
int dstpu_build_atoms(int n_entries,
                      const int32_t* tokens,
                      const int32_t* entry_meta,
                      const int32_t* blocks,
                      int S, int T, int max_blocks, int block_size,
                      int32_t* token_ids, int32_t* positions,
                      int32_t* slot_map, uint8_t* active,
                      int32_t* block_tables, int32_t* seq_lens,
                      int32_t* sample_idx, uint8_t* do_sample) {
  for (int e = 0; e < n_entries; ++e) {
    const int32_t* m = entry_meta + e * 7;
    const int s = m[0], n = m[1], start = m[2], sample = m[3];
    const int n_blocks = m[4], tok_off = m[5], blk_off = m[6];
    if (s < 0 || s >= S || n < 0 || n > T || start < 0 ||
        n_blocks < 0 || n_blocks > max_blocks || tok_off < 0 ||
        blk_off < 0)
      return 1 + e;
    int32_t* row_tok = token_ids + (int64_t)s * T;
    int32_t* row_pos = positions + (int64_t)s * T;
    int32_t* row_slot = slot_map + (int64_t)s * T;
    uint8_t* row_act = active + (int64_t)s * T;
    for (int j = 0; j < n; ++j) {
      const int pos = start + j;
      // rolling-buffer slot (mod is a no-op in linear mode)
      const int blk = blocks[blk_off + (pos / block_size) % max_blocks];
      row_tok[j] = tokens[tok_off + j];
      row_pos[j] = pos;
      row_slot[j] = blk * block_size + pos % block_size;
      row_act[j] = 1;
    }
    int32_t* table = block_tables + (int64_t)s * max_blocks;
    for (int b = 0; b < n_blocks; ++b) table[b] = blocks[blk_off + b];
    seq_lens[s] = start + n;
    sample_idx[s] = n - 1;
    do_sample[s] = (uint8_t)sample;
  }
  return 0;
}

}  // extern "C"
