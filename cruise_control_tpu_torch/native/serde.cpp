// Native batch deserializer for the metrics-reporter wire stream.
//
// The reference ingests metric records on the JVM inside each broker and in
// the service's sampler loop (CruiseControlMetricsReporterSampler.java:101
// poll loop; MetricSampleAggregator.addSample is called millions of times
// per window at LinkedIn scale — SURVEY §3.2 hot loop).  Our service-side
// analog is transport.poll() + a per-record Python loop: object-per-record
// allocation dominates.  This translation unit parses a whole framed batch
// in one pass into columnar arrays (and interns topic names), so the Python
// side works with numpy vectors instead of record objects.
//
// Record layout (little-endian, reporter/metrics.py MetricSerde):
//   class u8 | version u8 | metric_type u16 | time_ms i64 | broker i32 |
//   value f64  [| topic_len u16 | topic bytes  [| partition i32 ]]
// Batch framing: u32 record length before each record.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC serde.cpp -o ccnative.so  (see __init__.py)

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>

extern "C" {

// Returns the number of records parsed, or a negative error:
//   -1 malformed frame/record, -2 record capacity exceeded,
//   -3 topic-table capacity exceeded.
// topic_offsets/topic_lens describe each interned topic as a slice of the
// INPUT buffer (first occurrence); topic_ids[i] indexes that table (-1 for
// broker-scope records).  partitions[i] is -1 unless class==2.
long ccn_batch_deserialize(
    const uint8_t* buf, long n,
    uint8_t* class_ids, uint16_t* mtypes, int64_t* times, int32_t* brokers,
    double* values, int32_t* partitions, int32_t* topic_ids,
    int64_t* topic_offsets, int32_t* topic_lens, long max_topics,
    long* n_topics_out, long max_records) {
  std::unordered_map<std::string_view, int32_t> interned;
  interned.reserve(256);
  long count = 0;
  long off = 0;
  while (off + 4 <= n) {
    uint32_t rec_len;
    std::memcpy(&rec_len, buf + off, 4);
    off += 4;
    if (rec_len < 24 || off + (long)rec_len > n) return -1;
    if (count >= max_records) return -2;
    const uint8_t* r = buf + off;
    uint8_t cls = r[0];  // r[1] = version; all current versions share layout
    uint16_t mt;
    std::memcpy(&mt, r + 2, 2);
    int64_t tms;
    std::memcpy(&tms, r + 4, 8);
    int32_t bid;
    std::memcpy(&bid, r + 12, 4);
    double val;
    std::memcpy(&val, r + 16, 8);
    int32_t tid = -1;
    int32_t part = -1;
    if (cls != 0) {
      if (rec_len < 26) return -1;
      uint16_t tl;
      std::memcpy(&tl, r + 24, 2);
      if (26u + tl > rec_len) return -1;
      std::string_view topic(reinterpret_cast<const char*>(r + 26), tl);
      auto it = interned.find(topic);
      if (it == interned.end()) {
        if ((long)interned.size() >= max_topics) return -3;
        tid = (int32_t)interned.size();
        interned.emplace(topic, tid);
        topic_offsets[tid] = off + 26;
        topic_lens[tid] = tl;
      } else {
        tid = it->second;
      }
      if (cls == 2) {
        if (26u + tl + 4u > rec_len) return -1;
        std::memcpy(&part, r + 26 + tl, 4);
      }
    }
    class_ids[count] = cls;
    mtypes[count] = mt;
    times[count] = tms;
    brokers[count] = bid;
    values[count] = val;
    partitions[count] = part;
    topic_ids[count] = tid;
    ++count;
    off += rec_len;
  }
  if (off != n) return -1;  // trailing garbage
  *n_topics_out = (long)interned.size();
  return count;
}

// CRC-32C (Castagnoli) — the Kafka record-batch checksum.  Slice-by-8
// table walk; the Python fallback's per-byte loop is ~100x slower on the
// multi-MB fetch payloads the metrics consumer verifies every poll.
static uint32_t kCrcTable[8][256];
static bool kCrcInit = [] {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
    kCrcTable[0][n] = c;
  }
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = kCrcTable[0][n];
    for (int s = 1; s < 8; ++s) {
      c = kCrcTable[0][c & 0xFF] ^ (c >> 8);
      kCrcTable[s][n] = c;
    }
  }
  return true;
}();

uint32_t ccn_crc32c(const uint8_t* buf, long n, uint32_t crc) {
  (void)kCrcInit;
  crc = ~crc;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, buf, 8);
    w ^= crc;  // little-endian host assumed (x86/ARM LE)
    crc = kCrcTable[7][w & 0xFF] ^ kCrcTable[6][(w >> 8) & 0xFF] ^
          kCrcTable[5][(w >> 16) & 0xFF] ^ kCrcTable[4][(w >> 24) & 0xFF] ^
          kCrcTable[3][(w >> 32) & 0xFF] ^ kCrcTable[2][(w >> 40) & 0xFF] ^
          kCrcTable[1][(w >> 48) & 0xFF] ^ kCrcTable[0][(w >> 56) & 0xFF];
    buf += 8;
    n -= 8;
  }
  while (n--) crc = kCrcTable[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
