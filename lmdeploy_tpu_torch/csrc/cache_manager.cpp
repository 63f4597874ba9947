// Native KV-cache manager: page allocator + LRU sequence store.
//
// Copy of the repository's csrc/cache_manager.cpp for lmdeploy_tpu_torch
// (the port keeps its own sources); lmdeploy_tpu_torch/kvcache/native.py
// builds it with g++ at first use and binds its C ABI with ctypes.
//
// C++ rebuild of the reference's cache-of-KV-caches
// (src/turbomind/models/llama/LlamaCacheManager.cc): create/fetch/
// update/erase sequences, page-granular growth with LRU eviction of
// inactive sequences, evicted sequences keep token ids for cache-miss
// re-decode (LlamaBatch.cc:680-699), per-sequence RNG snapshot.
//
// Beyond-reference: cross-session PREFIX CACHING (mirrors
// lmdeploy_tpu_torch/kvcache/manager.py — see that module's docstring for
// the invariants).  Full pages are content-addressed by an FNV-1a chain
// digest of all tokens up to the page end; hits verify the stored token
// span exactly (walking from page 0 makes the whole prefix exact by
// induction), shared pages are reference-counted and immutable while
// referenced, and unreferenced index entries are LRU-reclaimed after
// live sessions under allocator pressure.
//
// The device pool is a tensor addressed by page tables; this manager owns
// the HOST-side bookkeeping only (page free list, session map, token
// histories) and is exposed to Python through a flat C ABI (ctypes).
//
// Build: g++ -O2 -fPIC -std=c++17 -shared cache_manager.cpp -o <lib>.so

#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Sequence {
  int64_t id = 0;
  std::vector<int32_t> tokens;
  std::vector<int32_t> pages;
  int32_t cache_len = 0;
  int32_t shared = 0;  // leading pages owned by the prefix index
  uint32_t rng[2] = {0, 0};
  bool has_rng = false;
  bool active = false;
  uint64_t stamp = 0;  // logical LRU clock
};

struct Published {
  int32_t page = 0;
  int32_t parent = -1;  // physical page holding the preceding span
  std::vector<int32_t> tokens;  // this page's span (verified on hit)
  uint64_t stamp = 0;
};

// FNV-1a 64 chain digest: lookup key only — hits verify token spans.
inline uint64_t chain_digest(uint64_t parent, const int32_t* toks,
                             int32_t n) {
  uint64_t h = parent ? parent : 1469598103934665603ull;
  for (int32_t i = 0; i < n; ++i) {
    uint32_t v = static_cast<uint32_t>(toks[i]);
    for (int b = 0; b < 4; ++b) {
      h ^= (v >> (8 * b)) & 0xff;
      h *= 1099511628211ull;
    }
  }
  return h ? h : 1;  // 0 is the "root" sentinel
}

class CacheManager {
 public:
  CacheManager(int32_t num_pages, int32_t page_size, int32_t max_entries)
      : page_size_(page_size), max_entries_(max_entries) {
    free_.reserve(num_pages);
    for (int32_t p = num_pages - 1; p >= 0; --p) free_.push_back(p);
  }

  int32_t free_pages() const {
    std::lock_guard<std::mutex> g(mu_);
    return static_cast<int32_t>(free_.size());
  }

  bool contains(int64_t id) const {
    std::lock_guard<std::mutex> g(mu_);
    return seqs_.count(id) != 0;
  }

  // (Re)create a session, dropping any prior state under this id.
  void create(int64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    erase_locked(id);
    Sequence s;
    s.id = id;
    s.stamp = ++clock_;
    seqs_.emplace(id, std::move(s));
    trim_locked(id);
  }

  bool erase(int64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    return erase_locked(id);
  }

  // Ensure pages cover total_tokens; LRU-evicts inactive sequences under
  // pressure. Returns the new page count, or -1 if unsatisfiable. All or
  // nothing, as the Python manager: the pages are taken only once enough
  // are free, so a refused grow leaves the sequence's pages as they were.
  int32_t grow(int64_t id, int32_t total_tokens) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    Sequence& s = it->second;
    int32_t need = (total_tokens + page_size_ - 1) / page_size_;
    int32_t want = need - static_cast<int32_t>(s.pages.size());
    while (static_cast<int32_t>(free_.size()) < want)
      if (!evict_one_locked(id)) return -1;
    for (int32_t i = 0; i < want; ++i) {
      s.pages.push_back(free_.back());
      free_.pop_back();
    }
    return static_cast<int32_t>(s.pages.size());
  }

  int32_t get_pages(int64_t id, int32_t* out, int32_t cap) const {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    const auto& p = it->second.pages;
    int32_t n = static_cast<int32_t>(p.size());
    if (out && cap >= n) std::memcpy(out, p.data(), n * sizeof(int32_t));
    return n;
  }

  void set_active(int64_t id, bool active) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return;
    it->second.active = active;
    it->second.stamp = ++clock_;
  }

  int32_t set_tokens(int64_t id, const int32_t* toks, int32_t n) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    it->second.tokens.assign(toks, toks + n);
    return n;
  }

  int32_t append_token(int64_t id, int32_t tok) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    it->second.tokens.push_back(tok);
    return static_cast<int32_t>(it->second.tokens.size());
  }

  int32_t get_tokens(int64_t id, int32_t* out, int32_t cap) const {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    const auto& t = it->second.tokens;
    int32_t n = static_cast<int32_t>(t.size());
    if (out && cap >= n) std::memcpy(out, t.data(), n * sizeof(int32_t));
    return n;
  }

  int32_t truncate_tokens(int64_t id, int32_t n) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    auto& s = it->second;
    if (n < static_cast<int32_t>(s.tokens.size())) s.tokens.resize(n);
    if (s.cache_len > n) s.cache_len = n;
    return static_cast<int32_t>(s.tokens.size());
  }

  int32_t cache_len(int64_t id) const {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    return it == seqs_.end() ? -1 : it->second.cache_len;
  }

  void set_cache_len(int64_t id, int32_t len) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it != seqs_.end()) it->second.cache_len = len;
  }

  void set_rng(int64_t id, uint32_t a, uint32_t b) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return;
    it->second.rng[0] = a;
    it->second.rng[1] = b;
    it->second.has_rng = true;
  }

  // returns 1 and fills out[2] if a snapshot exists, else 0
  int32_t get_rng(int64_t id, uint32_t* out) const {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end() || !it->second.has_rng) return 0;
    out[0] = it->second.rng[0];
    out[1] = it->second.rng[1];
    return 1;
  }

  // ---- prefix caching ----------------------------------------------------

  void set_prefix_enabled(bool on) {
    std::lock_guard<std::mutex> g(mu_);
    prefix_enabled_ = on;
  }

  // Attach published pages covering the longest page-aligned prefix of
  // ids[0..n) to a pageless sequence; returns the cached token count.
  // Caps at the last boundary strictly before the final token (the last
  // prompt token decodes into a private page).
  int32_t match_prefix(int64_t id, const int32_t* ids, int32_t n) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    Sequence& s = it->second;
    if (!prefix_enabled_ || !s.pages.empty() || n < 2) return 0;
    int32_t max_pages = (n - 1) / page_size_;
    uint64_t d = 0;
    int32_t parent = -1;  // ancestry by page IDENTITY, not by hash:
    // a hit requires the entry's recorded parent to be the physical page
    // we just attached, so equal pages imply equal prefixes by induction
    // (the 64-bit chain digest is only a bucket key; collisions can only
    // lose sharing, never attach a foreign prefix).
    for (int32_t i = 0; i < max_pages; ++i) {
      const int32_t* span = ids + i * page_size_;
      d = chain_digest(d, span, page_size_);
      ++prefix_lookups_;
      auto pit = prefix_.find(d);
      if (pit == prefix_.end() || pit->second.parent != parent ||
          std::memcmp(pit->second.tokens.data(), span,
                      page_size_ * sizeof(int32_t)) != 0)
        break;
      parent = pit->second.page;
      pit->second.stamp = ++clock_;
      s.pages.push_back(pit->second.page);
      ++refs_[pit->second.page];
      ++prefix_hits_;
    }
    s.shared = static_cast<int32_t>(s.pages.size());
    s.cache_len = s.shared * page_size_;
    return s.cache_len;
  }

  // Publish every full cached page into the index.  Adoption of an
  // existing copy is only safe when the sequence is not bound to a
  // batch slot (the device page row is rebuilt at next admission); an
  // ACTIVE sequence publishes insert-only — its pages become shareable
  // right after prefill, duplicates dedupe at retirement.
  void publish(int64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return;
    Sequence& s = it->second;
    if (!prefix_enabled_) return;
    const bool adopt = !s.active;
    int32_t full = s.cache_len / page_size_;
    if (full > static_cast<int32_t>(s.pages.size()))
      full = static_cast<int32_t>(s.pages.size());
    if (full * page_size_ > static_cast<int32_t>(s.tokens.size()))
      full = static_cast<int32_t>(s.tokens.size()) / page_size_;
    int32_t shared_upto = s.shared;
    uint64_t d = 0;
    for (int32_t i = 0; i < full; ++i) {
      const int32_t* span = s.tokens.data() + i * page_size_;
      const int32_t parent = i ? s.pages[i - 1] : -1;
      d = chain_digest(d, span, page_size_);
      auto pit = prefix_.find(d);
      if (pit != prefix_.end() && pit->second.parent == parent &&
          std::memcmp(pit->second.tokens.data(), span,
                      page_size_ * sizeof(int32_t)) == 0) {
        if (pit->second.page != s.pages[i]) {
          if (!adopt) {
            // keep the private duplicate while the device page row
            // points at it; shared_upto must not advance past it
            // (leading-prefix ownership invariant) — stop here.
            pit->second.stamp = ++clock_;
            break;
          }
          if (i < s.shared)
            deref_locked(s.pages[i]);
          else
            free_.push_back(s.pages[i]);
          s.pages[i] = pit->second.page;
          ++refs_[pit->second.page];
        }
        pit->second.stamp = ++clock_;
      } else if (pit == prefix_.end()) {
        Published e;
        e.page = s.pages[i];
        e.parent = parent;
        e.tokens.assign(span, span + page_size_);
        e.stamp = ++clock_;
        prefix_.emplace(d, std::move(e));
        refs_[s.pages[i]] += (i < s.shared) ? 1 : 2;
      } else {
        break;  // digest collision with different tokens
      }
      if (i + 1 > shared_upto) shared_upto = i + 1;
    }
    s.shared = shared_upto;
  }

  // Make writes from new_cache_len onward safe: shared pages at/after
  // the write point become fresh private pages; returns the effective
  // cache length (dropped to the boundary when the write point lands
  // inside a shared page), or -1 when allocation is unsatisfiable.
  int32_t prepare_rewrite(int64_t id, int32_t new_cache_len) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return -1;
    Sequence& s = it->second;
    int32_t j = new_cache_len / page_size_;
    if (s.shared <= j) return new_cache_len;
    for (int32_t i = j;
         i < s.shared && i < static_cast<int32_t>(s.pages.size()); ++i) {
      while (free_.empty())
        if (!evict_one_locked(id)) return -1;
      int32_t fresh = free_.back();
      free_.pop_back();
      deref_locked(s.pages[i]);
      s.pages[i] = fresh;
    }
    s.shared = j;
    int32_t bound = j * page_size_;
    return new_cache_len < bound ? new_cache_len : bound;
  }

  void flush_prefix() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto& [d, e] : prefix_) deref_locked(e.page);
    prefix_.clear();
  }

  void prefix_stats(int64_t* hits, int64_t* lookups) const {
    std::lock_guard<std::mutex> g(mu_);
    if (hits) *hits = prefix_hits_;
    if (lookups) *lookups = prefix_lookups_;
  }

  int32_t shared_pages(int64_t id) const {
    std::lock_guard<std::mutex> g(mu_);
    auto it = seqs_.find(id);
    return it == seqs_.end() ? -1 : it->second.shared;
  }

 private:
  void deref_locked(int32_t page) {
    auto rit = refs_.find(page);
    if (rit == refs_.end() || rit->second <= 1) {
      if (rit != refs_.end()) refs_.erase(rit);
      free_.push_back(page);
    } else {
      --rit->second;
    }
  }

  void drop_pages_locked(Sequence& s) {
    for (int32_t i = 0; i < static_cast<int32_t>(s.pages.size()); ++i) {
      if (i < s.shared)
        deref_locked(s.pages[i]);
      else
        free_.push_back(s.pages[i]);
    }
    s.pages.clear();
    s.cache_len = 0;
    s.shared = 0;
  }

  bool erase_locked(int64_t id) {
    auto it = seqs_.find(id);
    if (it == seqs_.end()) return false;
    drop_pages_locked(it->second);
    seqs_.erase(it);
    return true;
  }

  // Free the pages of the least-recently-used inactive sequence
  // (reference: LlamaCacheManager::evict:162-183 — token ids survive),
  // falling back to LRU unreferenced prefix-index pages.
  bool evict_one_locked(int64_t exclude) {
    Sequence* victim = nullptr;
    for (auto& [id, s] : seqs_) {
      if (s.active || s.pages.empty() || id == exclude) continue;
      if (!victim || s.stamp < victim->stamp) victim = &s;
    }
    if (victim) {
      drop_pages_locked(*victim);
      return true;
    }
    uint64_t best_d = 0;
    const Published* best = nullptr;
    for (auto& [d, e] : prefix_) {
      auto rit = refs_.find(e.page);
      if (rit != refs_.end() && rit->second == 1 &&
          (!best || e.stamp < best->stamp)) {
        best = &e;
        best_d = d;
      }
    }
    if (!best) return false;
    deref_locked(best->page);
    prefix_.erase(best_d);
    return true;
  }

  // Bound the session count (cache_max_entry_count) by erasing the oldest
  // inactive sessions; never ``keep``, the session being created (when
  // every other one is active, the count stays over the bound until some
  // session is released).
  void trim_locked(int64_t keep) {
    if (max_entries_ <= 0) return;
    while (static_cast<int32_t>(seqs_.size()) > max_entries_) {
      Sequence* victim = nullptr;
      for (auto& [id, s] : seqs_) {
        if (s.active || id == keep) continue;
        if (!victim || s.stamp < victim->stamp) victim = &s;
      }
      if (!victim) return;
      erase_locked(victim->id);
    }
  }

  mutable std::mutex mu_;
  std::unordered_map<int64_t, Sequence> seqs_;
  std::vector<int32_t> free_;
  std::unordered_map<uint64_t, Published> prefix_;
  std::unordered_map<int32_t, int32_t> refs_;  // shared-page owner count
  bool prefix_enabled_ = true;
  int64_t prefix_hits_ = 0;
  int64_t prefix_lookups_ = 0;
  int32_t page_size_;
  int32_t max_entries_;
  uint64_t clock_ = 0;
};

}  // namespace

extern "C" {

void* cm_create(int32_t num_pages, int32_t page_size, int32_t max_entries) {
  return new CacheManager(num_pages, page_size, max_entries);
}
void cm_destroy(void* h) { delete static_cast<CacheManager*>(h); }

#define CM static_cast<CacheManager*>(h)
int32_t cm_free_pages(void* h) { return CM->free_pages(); }
int32_t cm_contains(void* h, int64_t id) { return CM->contains(id); }
void cm_create_seq(void* h, int64_t id) { CM->create(id); }
int32_t cm_erase(void* h, int64_t id) { return CM->erase(id); }
int32_t cm_grow(void* h, int64_t id, int32_t total_tokens) {
  return CM->grow(id, total_tokens);
}
int32_t cm_get_pages(void* h, int64_t id, int32_t* out, int32_t cap) {
  return CM->get_pages(id, out, cap);
}
void cm_set_active(void* h, int64_t id, int32_t active) {
  CM->set_active(id, active != 0);
}
int32_t cm_set_tokens(void* h, int64_t id, const int32_t* toks, int32_t n) {
  return CM->set_tokens(id, toks, n);
}
int32_t cm_append_token(void* h, int64_t id, int32_t tok) {
  return CM->append_token(id, tok);
}
int32_t cm_get_tokens(void* h, int64_t id, int32_t* out, int32_t cap) {
  return CM->get_tokens(id, out, cap);
}
int32_t cm_truncate_tokens(void* h, int64_t id, int32_t n) {
  return CM->truncate_tokens(id, n);
}
int32_t cm_cache_len(void* h, int64_t id) { return CM->cache_len(id); }
void cm_set_cache_len(void* h, int64_t id, int32_t len) {
  CM->set_cache_len(id, len);
}
void cm_set_rng(void* h, int64_t id, uint32_t a, uint32_t b) {
  CM->set_rng(id, a, b);
}
int32_t cm_get_rng(void* h, int64_t id, uint32_t* out) {
  return CM->get_rng(id, out);
}
void cm_set_prefix_cache(void* h, int32_t enable) {
  CM->set_prefix_enabled(enable != 0);
}
int32_t cm_match_prefix(void* h, int64_t id, const int32_t* ids,
                        int32_t n) {
  return CM->match_prefix(id, ids, n);
}
void cm_publish(void* h, int64_t id) { CM->publish(id); }
int32_t cm_prepare_rewrite(void* h, int64_t id, int32_t new_cache_len) {
  return CM->prepare_rewrite(id, new_cache_len);
}
void cm_flush_prefix(void* h) { CM->flush_prefix(); }
void cm_prefix_stats(void* h, int64_t* hits, int64_t* lookups) {
  CM->prefix_stats(hits, lookups);
}
int32_t cm_shared_pages(void* h, int64_t id) { return CM->shared_pages(id); }
#undef CM

}  // extern "C"
