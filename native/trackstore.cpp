// Native track store: union-find merging of two-view matches into
// multi-view feature tracks.
//
// This is the engine's equivalent of the reference's GlobalSet
// (reference GlobalSet.py:22-172): a hash map from 2-D observations
// (image, x, y) to track ids, with threshold-gated merging and
// invalidate-on-violation semantics.  It is the single inherently
// sequential, hash-heavy piece of the pipeline, so it lives on the host as
// native code (the bulk geometry stays on device); the batched entry point
// ts_add_pairs consumes whole per-pair match arrays at once.
//
// Semantics mirrored from the reference (add2pts, GlobalSet.py:101-172):
//  - both observations unknown      -> new track holding the 3-D point
//  - one known                      -> if track valid && |p - track.p| < thr:
//                                      attach both obs (track point KEPT);
//                                      else invalidate the track
//  - both known, same track         -> threshold check, else invalidate
//  - both known, different tracks   -> if both valid && check vs track1:
//                                      merge track2 into track1 (track1's
//                                      point kept); else invalidate both
// Export enumerates valid tracks in creation order (matching getInfo,
// GlobalSet.py:36-50) and ts_update_world writes refined points back in the
// same order (updateWorldPoints, GlobalSet.py:52-57).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Track {
  double p[3];
  std::vector<uint64_t> obs;  // packed observation keys
  bool valid = true;
  bool alive = true;  // false once merged away
};

inline uint64_t pack_obs(int32_t img, int32_t x, int32_t y) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(img)) << 42) |
         (static_cast<uint64_t>(static_cast<uint32_t>(y) & 0x1FFFFF) << 21) |
         (static_cast<uint64_t>(static_cast<uint32_t>(x) & 0x1FFFFF));
}

struct TrackStore {
  double threshold;
  std::unordered_map<uint64_t, int32_t> index;  // obs key -> track id
  std::vector<Track> tracks;

  explicit TrackStore(double thr) : threshold(thr) {
    index.reserve(1 << 16);
  }

  bool check_threshold(int32_t id, const double* p) const {
    const double* a = tracks[id].p;
    double dx = a[0] - p[0], dy = a[1] - p[1], dz = a[2] - p[2];
    return std::sqrt(dx * dx + dy * dy + dz * dz) < threshold;
  }

  int32_t find(uint64_t key) const {
    auto it = index.find(key);
    return it == index.end() ? -1 : it->second;
  }

  void add_pair(uint64_t ka, uint64_t kb, const double* p) {
    int32_t i1 = find(ka), i2 = find(kb);
    if (i1 < 0 && i2 < 0) {
      int32_t id = static_cast<int32_t>(tracks.size());
      tracks.push_back(Track{{p[0], p[1], p[2]}, {ka, kb}, true, true});
      index[ka] = id;
      index[kb] = id;
    } else if (i1 < 0) {  // only kb known
      if (tracks[i2].valid && check_threshold(i2, p)) {
        index[ka] = i2;
        attach(i2, ka);
        attach(i2, kb);
      } else {
        tracks[i2].valid = false;
      }
    } else if (i2 < 0) {  // only ka known
      if (tracks[i1].valid && check_threshold(i1, p)) {
        index[kb] = i1;
        attach(i1, ka);
        attach(i1, kb);
      } else {
        tracks[i1].valid = false;
      }
    } else if (i1 == i2) {
      if (tracks[i1].valid && check_threshold(i1, p)) {
        attach(i1, ka);
        attach(i1, kb);
      } else {
        tracks[i1].valid = false;
      }
    } else {
      if (tracks[i1].valid && tracks[i2].valid && check_threshold(i1, p)) {
        // Merge track i2 into i1; i1's world point is kept.
        for (uint64_t k : tracks[i2].obs) {
          index[k] = i1;
          attach(i1, k);
        }
        tracks[i2].alive = false;
        tracks[i2].obs.clear();
      } else {
        tracks[i1].valid = false;
        tracks[i2].valid = false;
      }
    }
  }

  // Membership-checked append (the reference stores obs in a python set).
  void attach(int32_t id, uint64_t key) {
    auto& v = tracks[id].obs;
    for (uint64_t k : v)
      if (k == key) return;
    v.push_back(key);
  }
};

}  // namespace

extern "C" {

void* ts_create(double threshold) { return new TrackStore(threshold); }

void ts_destroy(void* h) { delete static_cast<TrackStore*>(h); }

void ts_add_pairs(void* h, int64_t n, const int32_t* obs_a,
                  const int32_t* obs_b, const double* pts) {
  auto* ts = static_cast<TrackStore*>(h);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t ka = pack_obs(obs_a[3 * i], obs_a[3 * i + 1], obs_a[3 * i + 2]);
    uint64_t kb = pack_obs(obs_b[3 * i], obs_b[3 * i + 1], obs_b[3 * i + 2]);
    ts->add_pair(ka, kb, pts + 3 * i);
  }
}

// Counts over valid tracks (creation order), matching getInfo.
void ts_info(void* h, int64_t* n_tracks, int64_t* n_obs) {
  auto* ts = static_cast<TrackStore*>(h);
  int64_t nt = 0, no = 0;
  for (const auto& t : ts->tracks) {
    if (t.alive && t.valid) {
      ++nt;
      no += static_cast<int64_t>(t.obs.size());
    }
  }
  *n_tracks = nt;
  *n_obs = no;
}

// Export valid tracks: world (n_tracks,3) f64, offsets (n_tracks+1) i64,
// obs (n_obs,3) i32 rows (img, x, y).  Buffers must be sized via ts_info.
void ts_export(void* h, double* world, int64_t* offsets, int32_t* obs) {
  auto* ts = static_cast<TrackStore*>(h);
  int64_t ti = 0, oi = 0;
  offsets[0] = 0;
  for (const auto& t : ts->tracks) {
    if (!(t.alive && t.valid)) continue;
    world[3 * ti] = t.p[0];
    world[3 * ti + 1] = t.p[1];
    world[3 * ti + 2] = t.p[2];
    for (uint64_t k : t.obs) {
      obs[3 * oi] = static_cast<int32_t>(k >> 42);
      obs[3 * oi + 1] = static_cast<int32_t>(k & 0x1FFFFF);          // x
      obs[3 * oi + 2] = static_cast<int32_t>((k >> 21) & 0x1FFFFF);  // y
      ++oi;
    }
    ++ti;
    offsets[ti] = oi;
  }
}

// Write refined world points back into valid tracks, creation order
// (updateWorldPoints, GlobalSet.py:52-57).
void ts_update_world(void* h, const double* pts, int64_t n) {
  auto* ts = static_cast<TrackStore*>(h);
  int64_t i = 0;
  for (auto& t : ts->tracks) {
    if (!(t.alive && t.valid)) continue;
    if (i >= n) break;
    t.p[0] = pts[3 * i];
    t.p[1] = pts[3 * i + 1];
    t.p[2] = pts[3 * i + 2];
    ++i;
  }
}

}  // extern "C"
