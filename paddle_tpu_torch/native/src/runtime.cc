// paddle_tpu_torch native runtime (reference: Paddle's C++ data pipeline —
// paddle/fluid/framework/blocking_queue.h, DataLoader worker pool, and the
// pinned-memory staging allocator paddle/fluid/memory/allocation/
// pinned_allocator.cc).
//
// Role: the card is fed from host RAM, so the pieces worth doing in C++
// are the ones that move bytes while Python holds no locks: a pthread
// worker pool, page-aligned staging arenas (the host-to-device copy reads
// from them), parallel gather/stack batch assembly
// (the hot half of collate), a blocking MPMC ring for prefetch handoff,
// and a trie tokenizer. Exposed as a C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#define PT_API extern "C" __attribute__((visibility("default")))

// ----------------------------------------------------------------- arena
// Bump allocator over one page-aligned slab. Batches are assembled here and
// handed to the host-to-device copy; reset() recycles the slab every step, so steady
// state does zero mallocs.
struct PtArena {
  uint8_t* base = nullptr;
  size_t cap = 0;
  std::atomic<size_t> off{0};
};

PT_API PtArena* pt_arena_create(size_t cap) {
  auto* a = new PtArena();
  // 4096: page alignment so the host->device DMA path never splits a page
  if (posix_memalign(reinterpret_cast<void**>(&a->base), 4096, cap) != 0) {
    delete a;
    return nullptr;
  }
  a->cap = cap;
  return a;
}

PT_API void* pt_arena_alloc(PtArena* a, size_t size) {
  size_t aligned = (size + 63) & ~size_t(63);  // 64B: cacheline/vector align
  size_t prev = a->off.fetch_add(aligned, std::memory_order_relaxed);
  if (prev + aligned > a->cap) {
    a->off.fetch_sub(aligned, std::memory_order_relaxed);
    return nullptr;
  }
  return a->base + prev;
}

PT_API void pt_arena_reset(PtArena* a) { a->off.store(0); }
PT_API size_t pt_arena_used(PtArena* a) { return a->off.load(); }
PT_API void pt_arena_destroy(PtArena* a) {
  if (a) { free(a->base); delete a; }
}

// ------------------------------------------------------------ thread pool
struct PtPool {
  std::vector<std::thread> threads;
  std::deque<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  size_t inflight = 0;
  bool stop = false;

  explicit PtPool(int n) {
    for (int i = 0; i < n; ++i) {
      threads.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !tasks.empty(); });
            if (stop && tasks.empty()) return;
            task = std::move(tasks.front());
            tasks.pop_front();
          }
          task();
          {
            std::lock_guard<std::mutex> lk(mu);
            if (--inflight == 0) done_cv.notify_all();
          }
        }
      });
    }
  }

  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      ++inflight;
      tasks.push_back(std::move(f));
    }
    cv.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this] { return inflight == 0; });
  }

  ~PtPool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : threads) t.join();
  }
};

PT_API PtPool* pt_pool_create(int n_threads) {
  return new PtPool(n_threads > 0 ? n_threads : 1);
}
PT_API void pt_pool_destroy(PtPool* p) { delete p; }
PT_API int pt_pool_size(PtPool* p) { return (int)p->threads.size(); }

// ------------------------------------------------------- batch assembly
// Parallel "np.stack": copy n same-sized items into one contiguous batch.
// The Python caller releases the GIL across this call (ctypes does), so
// collate overlaps with interpreter work in other threads.
PT_API void pt_gather_stack(PtPool* pool, const void** srcs, size_t n,
                            size_t item_bytes, void* dst) {
  const size_t kMinPerTask = 1 << 16;  // don't spawn tasks for tiny copies
  size_t per_task = item_bytes < kMinPerTask && n > 1
                        ? (kMinPerTask + item_bytes - 1) / item_bytes
                        : 1;
  for (size_t i = 0; i < n; i += per_task) {
    size_t hi = i + per_task < n ? i + per_task : n;
    pool->submit([=] {
      for (size_t j = i; j < hi; ++j) {
        memcpy(static_cast<uint8_t*>(dst) + j * item_bytes, srcs[j],
               item_bytes);
      }
    });
  }
  pool->wait();
}

// Ragged token sequences -> padded [n, max_len] batch (the LLM collate hot
// path). elem = element byte width; pad is the raw element bit pattern.
PT_API void pt_gather_pad(PtPool* pool, const void** srcs,
                          const size_t* lens, size_t n, size_t max_len,
                          size_t elem, const void* pad, void* dst) {
  for (size_t i = 0; i < n; ++i) {
    pool->submit([=] {
      auto* row = static_cast<uint8_t*>(dst) + i * max_len * elem;
      size_t len = lens[i] < max_len ? lens[i] : max_len;
      memcpy(row, srcs[i], len * elem);
      for (size_t j = len; j < max_len; ++j)
        memcpy(row + j * elem, pad, elem);
    });
  }
  pool->wait();
}

// --------------------------------------------------------------- ring
// Blocking MPMC ring of opaque u64 handles: the prefetch handoff between
// producer (collate) threads and the consumer (train loop). Close() wakes
// everyone; pop on a closed+empty ring returns 0.
struct PtRing {
  std::vector<uint64_t> buf;
  size_t head = 0, tail = 0, count = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full, not_empty;

  explicit PtRing(size_t cap) : buf(cap) {}
};

PT_API PtRing* pt_ring_create(size_t capacity) {
  return new PtRing(capacity ? capacity : 1);
}
PT_API void pt_ring_destroy(PtRing* r) { delete r; }

// returns 1 on success, 0 if closed, -1 on timeout
PT_API int pt_ring_push(PtRing* r, uint64_t value, int timeout_ms) {
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [r] { return r->closed || r->count < r->buf.size(); };
  if (timeout_ms < 0) {
    r->not_full.wait(lk, pred);
  } else if (!r->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   pred)) {
    return -1;
  }
  if (r->closed) return 0;
  r->buf[r->tail] = value;
  r->tail = (r->tail + 1) % r->buf.size();
  ++r->count;
  r->not_empty.notify_one();
  return 1;
}

// returns 1 with *out set, 0 if closed and drained, -1 on timeout
PT_API int pt_ring_pop(PtRing* r, uint64_t* out, int timeout_ms) {
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [r] { return r->closed || r->count > 0; };
  if (timeout_ms < 0) {
    r->not_empty.wait(lk, pred);
  } else if (!r->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    pred)) {
    return -1;
  }
  if (r->count == 0) return 0;  // closed and drained
  *out = r->buf[r->head];
  r->head = (r->head + 1) % r->buf.size();
  --r->count;
  r->not_full.notify_one();
  return 1;
}

PT_API void pt_ring_close(PtRing* r) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->not_full.notify_all();
  r->not_empty.notify_all();
}

PT_API size_t pt_ring_size(PtRing* r) {
  std::lock_guard<std::mutex> lk(r->mu);
  return r->count;
}

// ------------------------------------------------------------ tokenizer
// Greedy longest-match trie tokenizer ("tokenizer-lite"): covers BPE-style
// vocabs for data prep without a Python inner loop. Vocab = id-ordered
// newline-separated byte strings; unknown bytes emit unk_id.
struct TrieNode {
  std::unordered_map<uint8_t, TrieNode*> next;
  int32_t id = -1;
  ~TrieNode() {
    for (auto& kv : next) delete kv.second;
  }
};

struct PtTokenizer {
  TrieNode root;
  int32_t unk_id = 0;
  size_t vocab_size = 0;
};

PT_API PtTokenizer* pt_tok_create(const char* vocab, size_t vocab_bytes,
                                  int32_t unk_id) {
  auto* t = new PtTokenizer();
  t->unk_id = unk_id;
  int32_t id = 0;
  size_t start = 0;
  for (size_t i = 0; i <= vocab_bytes; ++i) {
    if (i == vocab_bytes || vocab[i] == '\n') {
      if (i > start) {
        TrieNode* node = &t->root;
        for (size_t j = start; j < i; ++j) {
          uint8_t c = (uint8_t)vocab[j];
          auto it = node->next.find(c);
          if (it == node->next.end()) {
            node = node->next[c] = new TrieNode();
          } else {
            node = it->second;
          }
        }
        node->id = id;
      }
      ++id;
      start = i + 1;
    }
  }
  t->vocab_size = (size_t)id;
  return t;
}

PT_API void pt_tok_destroy(PtTokenizer* t) { delete t; }
PT_API size_t pt_tok_vocab_size(PtTokenizer* t) { return t->vocab_size; }

// Greedy longest match; returns number of ids written (<= max_out).
PT_API size_t pt_tok_encode(PtTokenizer* t, const char* text, size_t len,
                            int32_t* out, size_t max_out) {
  size_t n = 0, i = 0;
  while (i < len && n < max_out) {
    TrieNode* node = &t->root;
    int32_t best = -1;
    size_t best_len = 0;
    for (size_t j = i; j < len; ++j) {
      auto it = node->next.find((uint8_t)text[j]);
      if (it == node->next.end()) break;
      node = it->second;
      if (node->id >= 0) {
        best = node->id;
        best_len = j - i + 1;
      }
    }
    if (best >= 0) {
      out[n++] = best;
      i += best_len;
    } else {
      out[n++] = t->unk_id;
      i += 1;
    }
  }
  return n;
}

// Batch encode on the pool: texts are concatenated; offsets[i] delimits
// text i. Output is padded to max_out per row; out_lens gets true lengths.
PT_API void pt_tok_encode_batch(PtTokenizer* t, PtPool* pool,
                                const char* blob, const size_t* offsets,
                                size_t n, int32_t* out, size_t max_out,
                                int32_t pad_id, size_t* out_lens) {
  for (size_t i = 0; i < n; ++i) {
    pool->submit([=] {
      const char* text = blob + offsets[i];
      size_t len = offsets[i + 1] - offsets[i];
      int32_t* row = out + i * max_out;
      size_t m = pt_tok_encode(t, text, len, row, max_out);
      for (size_t j = m; j < max_out; ++j) row[j] = pad_id;
      out_lens[i] = m;
    });
  }
  pool->wait();
}
