// Host spill store: the keyed-state tier behind the device table.
//
// Records whose key finds no slot in the device state table land in the
// device overflow ring; the executor drains that ring into one store per
// pane (runtime/executor.py) and merges the stores into every window it
// fires. Batch-first: put/get/delete take whole arrays per call, so the
// Python boundary is crossed once per drained pane, not per key.
//
// Layout: open-addressing hash table (u64 key -> fixed-width float block),
// linear probing, power-of-two capacity, automatic grow at 70% load.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct Spill {
  std::vector<uint64_t> keys;
  std::vector<uint8_t> used;   // slot holds a key
  std::vector<float> vals;      // capacity * width
  uint64_t capacity;
  uint64_t width;               // floats per value block
  uint64_t count;
};

static uint64_t mix(uint64_t k) {
  k ^= k >> 33; k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33; k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33; return k;
}

Spill* spill_create(uint64_t initial_capacity, uint64_t width) {
  uint64_t cap = 16;
  while (cap < initial_capacity) cap <<= 1;
  Spill* s = new Spill();
  s->capacity = cap;
  s->width = width;
  s->count = 0;
  s->keys.assign(cap, 0);
  s->used.assign(cap, 0);
  s->vals.assign(cap * width, 0.f);
  return s;
}

void spill_destroy(Spill* s) { delete s; }
uint64_t spill_count(Spill* s) { return s->count; }
uint64_t spill_capacity(Spill* s) { return s->capacity; }
uint64_t spill_width(Spill* s) { return s->width; }

static uint64_t find_slot(Spill* s, uint64_t key, int* found) {
  uint64_t mask = s->capacity - 1;
  uint64_t i = mix(key) & mask;
  while (s->used[i]) {
    if (s->keys[i] == key) { *found = 1; return i; }
    i = (i + 1) & mask;
  }
  *found = 0;
  return i;
}

static void grow(Spill* s) {
  Spill* bigger = spill_create(s->capacity * 2, s->width);
  for (uint64_t i = 0; i < s->capacity; i++) {
    if (!s->used[i]) continue;
    int f;
    uint64_t j = find_slot(bigger, s->keys[i], &f);
    bigger->used[j] = 1;
    bigger->keys[j] = s->keys[i];
    std::memcpy(&bigger->vals[j * s->width], &s->vals[i * s->width],
                s->width * sizeof(float));
    bigger->count++;
  }
  s->keys.swap(bigger->keys);
  s->used.swap(bigger->used);
  s->vals.swap(bigger->vals);
  s->capacity = bigger->capacity;
  delete bigger;
}

// Batch upsert: n entries, values is [n * width].
void spill_put_batch(Spill* s, const uint64_t* keys, const float* values,
                     uint64_t n) {
  for (uint64_t k = 0; k < n; k++) {
    if ((s->count + 1) * 10 > s->capacity * 7) grow(s);
    int f;
    uint64_t i = find_slot(s, keys[k], &f);
    if (!f) { s->used[i] = 1; s->keys[i] = keys[k]; s->count++; }
    std::memcpy(&s->vals[i * s->width], &values[k * s->width],
                s->width * sizeof(float));
  }
}

// Batch get: fills values [n * width] and found [n]; missing -> zeros.
void spill_get_batch(Spill* s, const uint64_t* keys, float* values,
                     uint8_t* found, uint64_t n) {
  for (uint64_t k = 0; k < n; k++) {
    int f;
    uint64_t i = find_slot(s, keys[k], &f);
    found[k] = (uint8_t)f;
    if (f) {
      std::memcpy(&values[k * s->width], &s->vals[i * s->width],
                  s->width * sizeof(float));
    } else {
      std::memset(&values[k * s->width], 0, s->width * sizeof(float));
    }
  }
}

// Batch delete; returns #removed.
uint64_t spill_delete_batch(Spill* s, const uint64_t* keys, uint64_t n) {
  uint64_t removed = 0;
  uint64_t mask = s->capacity - 1;
  for (uint64_t k = 0; k < n; k++) {
    int f;
    uint64_t i = find_slot(s, keys[k], &f);
    if (!f) continue;
    // backward-shift deletion keeps probe chains intact
    s->used[i] = 0;
    s->count--;
    removed++;
    uint64_t j = i;
    while (true) {
      j = (j + 1) & mask;
      if (!s->used[j]) break;
      uint64_t home = mix(s->keys[j]) & mask;
      // can slot j's entry legally move into the hole at i?
      uint64_t dist_cur = (j - home) & mask;
      uint64_t dist_new = (i - home) & mask;
      if (dist_new <= dist_cur) {
        s->keys[i] = s->keys[j];
        std::memcpy(&s->vals[i * s->width], &s->vals[j * s->width],
                    s->width * sizeof(float));
        s->used[i] = 1;
        s->used[j] = 0;
        i = j;
      }
    }
  }
  return removed;
}

// Dump all live entries: keys_out [count], vals_out
// [count * width]; returns count written (caller sizes via spill_count).
uint64_t spill_dump(Spill* s, uint64_t* keys_out, float* vals_out,
                    uint64_t max_n) {
  uint64_t w = 0;
  for (uint64_t i = 0; i < s->capacity && w < max_n; i++) {
    if (!s->used[i]) continue;
    keys_out[w] = s->keys[i];
    std::memcpy(&vals_out[w * s->width], &s->vals[i * s->width],
                s->width * sizeof(float));
    w++;
  }
  return w;
}

}  // extern "C"
