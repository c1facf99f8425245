// Round trip of the reference's 8-column test table through the port's
// handle-model C ABI (libtpudf_rt.so), driven entirely from C: this
// program owns Py_Initialize, as a JVM embedding the bridge would. The
// twin of the reference's src/native/src/rt_selftest.cpp.
//
// Environment: TPUDF_PY_PATH (':'-separated sys.path entries: the repo
// root and the site-packages that hold torch), TPUDF_RT_PLATFORM (""
// for the CUDA device, the default; "cpu" for the CPU).
//
// Table parity: reference RowConversionTest.java:30-39 —
//   col0 INT64       {3, 9, 4, 2, 20, null}
//   col1 FLOAT64     {5.0, 9.5, 0.9, 7.23, 2.8, null}
//   col2 INT32       {5, 1, 0, 2, 7, null}
//   col3 BOOL8       {true, false, false, true, false, null}
//   col4 FLOAT32     {1.0, 3.5, 5.9, 7.1, 9.8, null}
//   col5 INT8        {2, 3, 4, 5, 9, null}
//   col6 DECIMAL32(-3) of {5.0, 9.5, 0.9, 7.23, 2.8, null}  (unscaled e3)
//   col7 DECIMAL64(-8) of {3, 9, 4, 2, 20, null}             (unscaled e8)
// Assertions mirror the test: one batch, row count preserved, full table
// equality after convertFromRows (AssertUtils.assertTablesAreEqual
// semantics: per-column dtype, validity, and valid values).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int32_t tpudf_rt_init(char const* sys_path, char const* platform);
char const* tpudf_rt_last_error();
int64_t tpudf_rt_column_from_host(int32_t type_id, int32_t scale, int64_t n,
                                  uint8_t const* data, int64_t data_len,
                                  uint8_t const* validity);
int64_t tpudf_rt_table_create(int64_t const* cols, int32_t ncols);
int32_t tpudf_rt_table_num_columns(int64_t tbl);
int64_t tpudf_rt_table_num_rows(int64_t tbl);
int64_t tpudf_rt_table_column(int64_t tbl, int32_t i);
int32_t tpudf_rt_column_info(int64_t col, int32_t* type_id, int32_t* scale,
                             int64_t* num_rows);
int32_t tpudf_rt_column_to_host(int64_t col, uint8_t* data_out,
                                int64_t data_cap, uint8_t* validity_out,
                                int64_t validity_cap);
int32_t tpudf_rt_convert_to_rows(int64_t tbl, int64_t* out, int32_t cap,
                                 int32_t* n_out);
int64_t tpudf_rt_convert_from_rows(int64_t rows, int32_t const* type_ids,
                                   int32_t const* scales, int32_t ncols);
int32_t tpudf_rt_rows_info(int64_t rows, int64_t* num_rows, int64_t* row_size);
int32_t tpudf_rt_free(int64_t handle);
}

namespace {

// cuDF type ids (types.py TypeId)
constexpr int32_t INT8 = 1, INT32 = 3, INT64 = 4, FLOAT32 = 9, FLOAT64 = 10,
                  BOOL8 = 11, DECIMAL32 = 25, DECIMAL64 = 26;
constexpr int64_t N = 6;

int g_failures = 0;

void check(bool ok, char const* what) {
  if (!ok) {
    std::fprintf(stderr, "FAIL: %s (last_error: %s)\n", what,
                 tpudf_rt_last_error());
    ++g_failures;
  }
}

struct Col {
  int32_t type_id;
  int32_t scale;
  std::vector<uint8_t> data;
  std::vector<uint8_t> validity;  // 1 byte per row
};

template <typename T>
Col make_col(int32_t type_id, int32_t scale, std::vector<T> vals,
             std::vector<uint8_t> validity) {
  Col c;
  c.type_id = type_id;
  c.scale = scale;
  c.data.resize(vals.size() * sizeof(T));
  std::memcpy(c.data.data(), vals.data(), c.data.size());
  c.validity = std::move(validity);
  return c;
}

}  // namespace

int main() {
  char const* repo = std::getenv("TPUDF_PY_PATH");
  char const* platform = std::getenv("TPUDF_RT_PLATFORM");
  check(tpudf_rt_init(repo == nullptr ? "" : repo,
                      platform == nullptr ? "" : platform) == 0,
        "rt_init");
  if (g_failures) return 1;

  std::vector<uint8_t> tail_null = {1, 1, 1, 1, 1, 0};
  std::vector<Col> cols;
  cols.push_back(make_col<int64_t>(INT64, 0, {3, 9, 4, 2, 20, 0}, tail_null));
  cols.push_back(
      make_col<double>(FLOAT64, 0, {5.0, 9.5, 0.9, 7.23, 2.8, 0.0}, tail_null));
  cols.push_back(make_col<int32_t>(INT32, 0, {5, 1, 0, 2, 7, 0}, tail_null));
  cols.push_back(make_col<uint8_t>(BOOL8, 0, {1, 0, 0, 1, 0, 0}, tail_null));
  cols.push_back(make_col<float>(
      FLOAT32, 0, {1.0f, 3.5f, 5.9f, 7.1f, 9.8f, 0.0f}, tail_null));
  cols.push_back(make_col<int8_t>(INT8, 0, {2, 3, 4, 5, 9, 0}, tail_null));
  cols.push_back(make_col<int32_t>(
      DECIMAL32, -3, {5000, 9500, 900, 7230, 2800, 0}, tail_null));
  cols.push_back(make_col<int64_t>(
      DECIMAL64, -8,
      {300000000LL, 900000000LL, 400000000LL, 200000000LL, 2000000000LL, 0},
      tail_null));

  std::vector<int64_t> col_handles;
  for (auto const& c : cols) {
    int64_t h = tpudf_rt_column_from_host(
        c.type_id, c.scale, N, c.data.data(),
        static_cast<int64_t>(c.data.size()), c.validity.data());
    check(h > 0, "column_from_host");
    col_handles.push_back(h);
  }
  int64_t tbl = tpudf_rt_table_create(col_handles.data(),
                                      static_cast<int32_t>(col_handles.size()));
  check(tbl > 0, "table_create");
  check(tpudf_rt_table_num_columns(tbl) == 8, "num_columns == 8");
  check(tpudf_rt_table_num_rows(tbl) == N, "num_rows == 6");

  // device row conversion: columnar -> packed rows
  int64_t batches[4] = {0, 0, 0, 0};
  int32_t n_batches = 0;
  check(tpudf_rt_convert_to_rows(tbl, batches, 4, &n_batches) == 0,
        "convert_to_rows");
  check(n_batches == 1, "no batch overflow (rows.length == 1)");
  int64_t rows_n = 0, row_size = 0;
  check(tpudf_rt_rows_info(batches[0], &rows_n, &row_size) == 0, "rows_info");
  check(rows_n == N, "row count preserved");

  // packed rows -> columnar, with the recorded (typeId, scale) schema
  std::vector<int32_t> type_ids, scales;
  for (auto const& c : cols) {
    type_ids.push_back(c.type_id);
    scales.push_back(c.scale);
  }
  int64_t back = tpudf_rt_convert_from_rows(
      batches[0], type_ids.data(), scales.data(),
      static_cast<int32_t>(type_ids.size()));
  check(back > 0, "convert_from_rows");

  // assertTablesAreEqual: dtype + validity + valid values per column
  for (int32_t i = 0; i < 8; ++i) {
    int64_t col = tpudf_rt_table_column(back, i);
    check(col > 0, "table_column");
    int32_t tid = 0, scale = 0;
    int64_t n = 0;
    check(tpudf_rt_column_info(col, &tid, &scale, &n) == 0, "column_info");
    check(tid == cols[i].type_id, "dtype preserved");
    check(scale == cols[i].scale, "scale preserved");
    check(n == N, "column length");
    std::vector<uint8_t> data(cols[i].data.size());
    std::vector<uint8_t> validity(N);
    check(tpudf_rt_column_to_host(col, data.data(),
                                  static_cast<int64_t>(data.size()),
                                  validity.data(), N) == 0,
          "column_to_host");
    check(validity == cols[i].validity, "validity round-trips");
    size_t elem = cols[i].data.size() / N;
    for (int64_t r = 0; r + 1 < N; ++r) {  // last row is null: value unspecified
      check(std::memcmp(data.data() + r * elem,
                        cols[i].data.data() + r * elem, elem) == 0,
            "valid values round-trip");
    }
    tpudf_rt_free(col);
  }

  tpudf_rt_free(back);
  tpudf_rt_free(batches[0]);
  tpudf_rt_free(tbl);
  for (int64_t h : col_handles) tpudf_rt_free(h);

  if (g_failures == 0) {
    std::printf("tpudf_rt_selftest: all checks passed\n");
    return 0;
  }
  std::fprintf(stderr, "tpudf_rt_selftest: %d failures\n", g_failures);
  return 1;
}
