// Native BPE encoder (reference: the reference stack tokenizes with a
// compiled tokenizer — HF tokenizers' Rust merge loop — while our
// tokenizer/bpe.py runs the merge loop in Python; this is the C++ hot
// path for data prep).
//
// Works on RAW BYTES: the GPT-2 byte<->unicode table is a bijection, so
// running the rank-ordered merge loop on byte strings yields exactly the
// ids the printable-alphabet form does. Python keeps the regex
// pretokenizer and special-token handling; each pretokenized word comes
// here as bytes. A word-level memo cache makes corpus encoding O(unique
// words).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#define PT_API extern "C" __attribute__((visibility("default")))

namespace {

struct Bpe {
  // token bytes -> id (for multi-byte lookups after merges)
  std::unordered_map<std::string, int32_t> vocab;
  // id -> token bytes (to key the pair map by content)
  std::vector<std::string> id_bytes;
  // (left_id << 32 | right_id) -> {rank, merged_id}
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> pairs;
  int32_t byte_id[256];
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;
  size_t cache_cap = 1 << 16;
};

inline uint64_t pack(int32_t l, int32_t r) {
  return (uint64_t(uint32_t(l)) << 32) | uint32_t(r);
}

}  // namespace

PT_API Bpe* pt_bpe_create(int32_t n_vocab, const uint8_t* blob,
                          const int32_t* offsets, const int32_t* ids,
                          int32_t max_id, int32_t n_merges,
                          const int32_t* merge_l, const int32_t* merge_r,
                          const int32_t* merge_m) {
  auto* t = new Bpe();
  for (int i = 0; i < 256; ++i) t->byte_id[i] = -1;
  t->id_bytes.assign(size_t(max_id) + 1, std::string());
  for (int32_t i = 0; i < n_vocab; ++i) {
    std::string tok(reinterpret_cast<const char*>(blob + offsets[i]),
                    size_t(offsets[i + 1] - offsets[i]));
    int32_t id = ids[i];
    t->vocab.emplace(tok, id);
    if (id >= 0 && size_t(id) < t->id_bytes.size()) t->id_bytes[id] = tok;
    if (tok.size() == 1) t->byte_id[uint8_t(tok[0])] = id;
  }
  for (int32_t i = 0; i < n_merges; ++i) {
    // LAST occurrence wins on duplicate pairs — exactly the dict
    // comprehension the Python side builds ranks with
    t->pairs[pack(merge_l[i], merge_r[i])] = std::make_pair(i, merge_m[i]);
  }
  return t;
}

PT_API void pt_bpe_destroy(Bpe* t) { delete t; }

static void encode_uncached(Bpe* t, const uint8_t* word, int32_t len,
                            std::vector<int32_t>& out) {
  out.clear();
  for (int32_t i = 0; i < len; ++i) {
    int32_t id = t->byte_id[word[i]];
    if (id < 0) {  // byte not in vocab: caller takes the Python loop
      out.clear();
      out.push_back(-1);
      return;
    }
    out.push_back(id);
  }
  while (out.size() > 1) {
    int32_t best_rank = INT32_MAX, merged = -1;
    for (size_t i = 0; i + 1 < out.size(); ++i) {
      auto it = t->pairs.find(pack(out[i], out[i + 1]));
      if (it != t->pairs.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        merged = it->second.second;
      }
    }
    if (merged < 0) break;
    // fuse every occurrence of the chosen pair in one pass
    std::vector<int32_t> next;
    next.reserve(out.size());
    for (size_t i = 0; i < out.size();) {
      if (i + 1 < out.size()) {
        auto it = t->pairs.find(pack(out[i], out[i + 1]));
        if (it != t->pairs.end() && it->second.first == best_rank) {
          next.push_back(it->second.second);
          i += 2;
          continue;
        }
      }
      next.push_back(out[i]);
      ++i;
    }
    out.swap(next);
  }
}

// Encode a batch of pretokenized words (concatenated bytes + offsets).
// Returns total ids written, or -(failed_word_index + 1) if a word needs
// the Python fallback (unknown byte), or -1000000 if out_cap too small.
PT_API int64_t pt_bpe_encode_words(Bpe* t, const uint8_t* blob,
                                   const int32_t* offsets, int32_t n_words,
                                   int32_t* out, int64_t out_cap,
                                   int32_t* word_ends) {
  int64_t n_out = 0;
  std::vector<int32_t> ids;
  for (int32_t w = 0; w < n_words; ++w) {
    const uint8_t* word = blob + offsets[w];
    int32_t len = offsets[w + 1] - offsets[w];
    std::string key(reinterpret_cast<const char*>(word), size_t(len));
    bool cached = false;
    {
      std::lock_guard<std::mutex> lk(t->cache_mu);
      auto it = t->cache.find(key);
      if (it != t->cache.end()) {
        ids = it->second;
        cached = true;
      }
    }
    if (!cached) {
      encode_uncached(t, word, len, ids);
      if (ids.size() == 1 && ids[0] == -1) return -int64_t(w) - 1;
      std::lock_guard<std::mutex> lk(t->cache_mu);
      if (t->cache.size() < t->cache_cap) t->cache.emplace(key, ids);
    }
    if (n_out + int64_t(ids.size()) > out_cap) return -1000000;
    std::memcpy(out + n_out, ids.data(), ids.size() * sizeof(int32_t));
    n_out += int64_t(ids.size());
    word_ends[w] = int32_t(n_out);
  }
  return n_out;
}
