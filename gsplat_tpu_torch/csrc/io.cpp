// Host-side reader of COLMAP binary models and 3DGS PLY files, for the
// PyTorch port (gsplat_tpu_torch/io_native.py).  COLMAP's points3D.bin and
// images.bin are record-streamed (variable-length tracks), so a Python loop
// over them pays the interpreter once a record; here it is one buffered
// pass.  Built by g++ into a shared library (gsplat_tpu_torch/_build.py,
// `load_host`) and called through ctypes.
//
// A plain C ABI with a two-phase contract: *_count() sizes the buffers,
// *_read() fills them.  Every output is a little-endian host array.
//
// Parity: the readers of gsplat_tpu_torch/datasets/colmap.py
// (read_{cameras,images,points3d}_binary) and
// gsplat_tpu_torch/exporter.py:load_ply_to_splats.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
    FILE* f = nullptr;
    bool ok = false;
    explicit Reader(const char* path) {
        f = std::fopen(path, "rb");
        ok = f != nullptr;
    }
    ~Reader() {
        if (f) std::fclose(f);
    }
    template <typename T>
    bool read(T* out, size_t n = 1) {
        return std::fread(out, sizeof(T), n, f) == n;
    }
    // Skips n bytes.  A short skip reads through the stdio buffer: glibc's
    // fseek drops that buffer, which would cost two system calls a record
    // (a COLMAP track or a row of 2D points is tens of bytes).
    bool skip(long n) {
        char scratch[4096];
        if (n <= (long)sizeof(scratch)) return n <= 0 || read(scratch, (size_t)n);
        return std::fseek(f, n, SEEK_CUR) == 0;
    }
};

// COLMAP camera model id -> parameter count (colmap/src/base/camera_models.h)
int camera_model_params(int model_id) {
    switch (model_id) {
        case 0: return 3;   // SIMPLE_PINHOLE
        case 1: return 4;   // PINHOLE
        case 2: return 4;   // SIMPLE_RADIAL
        case 3: return 5;   // RADIAL
        case 4: return 8;   // OPENCV
        case 5: return 8;   // OPENCV_FISHEYE
        case 6: return 12;  // FULL_OPENCV
        case 7: return 5;   // FOV
        case 8: return 4;   // SIMPLE_RADIAL_FISHEYE
        case 9: return 5;   // RADIAL_FISHEYE
        case 10: return 12; // THIN_PRISM_FISHEYE
        default: return -1;
    }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// points3D.bin
// ---------------------------------------------------------------------------

// Returns the number of points, or -1 on error.
long long colmap_points3d_count(const char* path) {
    Reader r(path);
    if (!r.ok) return -1;
    uint64_t n;
    if (!r.read(&n)) return -1;
    return (long long)n;
}

// xyz [n*3] f64, rgb [n*3] u8, err [n] f64. Returns n read or -1.
long long colmap_points3d_read(const char* path, double* xyz, uint8_t* rgb,
                               double* err) {
    Reader r(path);
    if (!r.ok) return -1;
    uint64_t n;
    if (!r.read(&n)) return -1;
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t pid, track_len;
        if (!r.read(&pid)) return -1;
        if (!r.read(xyz + 3 * i, 3)) return -1;
        if (!r.read(rgb + 3 * i, 3)) return -1;
        if (!r.read(err + i)) return -1;
        if (!r.read(&track_len)) return -1;
        if (!r.skip((long)(8 * track_len))) return -1;  // (image_id, pt2d_idx) u32 pairs
    }
    return (long long)n;
}

// ---------------------------------------------------------------------------
// images.bin
// ---------------------------------------------------------------------------

long long colmap_images_count(const char* path) {
    Reader r(path);
    if (!r.ok) return -1;
    uint64_t n;
    if (!r.read(&n)) return -1;
    return (long long)n;
}

// Per image: id i32, qvec [4] f64 (wxyz), tvec [3] f64, camera_id i32,
// name (NUL-joined into `names`, capacity names_cap incl. NULs).
// Returns n read, or -1 on error / -2 if names buffer too small.
long long colmap_images_read(const char* path, int32_t* ids, double* qvecs,
                             double* tvecs, int32_t* camera_ids, char* names,
                             long long names_cap) {
    Reader r(path);
    if (!r.ok) return -1;
    uint64_t n;
    if (!r.read(&n)) return -1;
    long long name_pos = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if (!r.read(ids + i)) return -1;
        if (!r.read(qvecs + 4 * i, 4)) return -1;
        if (!r.read(tvecs + 3 * i, 3)) return -1;
        if (!r.read(camera_ids + i)) return -1;
        // NUL-terminated name
        for (;;) {
            int ch = std::fgetc(r.f);
            if (ch == EOF) return -1;
            if (name_pos >= names_cap) return -2;
            names[name_pos++] = (char)ch;
            if (ch == 0) break;
        }
        uint64_t n_pts;
        if (!r.read(&n_pts)) return -1;
        if (!r.skip((long)(24 * n_pts))) return -1;  // xy f64 pairs + point ids
    }
    return (long long)n;
}

// ---------------------------------------------------------------------------
// cameras.bin
// ---------------------------------------------------------------------------

long long colmap_cameras_count(const char* path) {
    Reader r(path);
    if (!r.ok) return -1;
    uint64_t n;
    if (!r.read(&n)) return -1;
    return (long long)n;
}

// Per camera: id i32, model_id i32, width/height i64, params [12] f64
// (zero padded; n_params written to param_counts). Returns n or -1.
long long colmap_cameras_read(const char* path, int32_t* ids,
                              int32_t* model_ids, int64_t* widths,
                              int64_t* heights, double* params,
                              int32_t* param_counts) {
    Reader r(path);
    if (!r.ok) return -1;
    uint64_t n;
    if (!r.read(&n)) return -1;
    for (uint64_t i = 0; i < n; ++i) {
        if (!r.read(ids + i)) return -1;
        if (!r.read(model_ids + i)) return -1;
        uint64_t w, h;
        if (!r.read(&w) || !r.read(&h)) return -1;
        widths[i] = (int64_t)w;
        heights[i] = (int64_t)h;
        int np = camera_model_params(model_ids[i]);
        if (np < 0 || np > 12) return -1;
        param_counts[i] = np;
        std::memset(params + 12 * i, 0, 12 * sizeof(double));
        if (!r.read(params + 12 * i, (size_t)np)) return -1;
    }
    return (long long)n;
}

// ---------------------------------------------------------------------------
// 3DGS PLY (binary little-endian float vertex properties)
// ---------------------------------------------------------------------------

// Parses the header: returns n_vertices, writes the number of float
// properties to n_props and the property names (NUL-joined) into
// prop_names. Returns -1 on error / unsupported format.
long long ply_header(const char* path, int32_t* n_props, char* prop_names,
                     long long names_cap, int64_t* data_offset) {
    Reader r(path);
    if (!r.ok) return -1;
    char line[512];
    long long n_vertices = -1;
    int props = 0;
    long long name_pos = 0;
    bool binary_le = false;
    while (std::fgets(line, sizeof(line), r.f)) {
        if (std::strncmp(line, "format binary_little_endian", 27) == 0) {
            binary_le = true;
        } else if (std::strncmp(line, "element vertex ", 15) == 0) {
            n_vertices = std::atoll(line + 15);
        } else if (std::strncmp(line, "property float ", 15) == 0) {
            const char* name = line + 15;
            size_t len = std::strlen(name);
            while (len && (name[len - 1] == '\n' || name[len - 1] == '\r'))
                --len;
            if (name_pos + (long long)len + 1 > names_cap) return -2;
            std::memcpy(prop_names + name_pos, name, len);
            name_pos += len;
            prop_names[name_pos++] = 0;
            ++props;
        } else if (std::strncmp(line, "end_header", 10) == 0) {
            break;
        }
    }
    if (!binary_le || n_vertices < 0) return -1;
    *n_props = props;
    *data_offset = std::ftell(r.f);
    return n_vertices;
}

// Reads the vertex block: out [n_vertices * n_props] f32. Returns n or -1.
long long ply_read_vertices(const char* path, int64_t data_offset,
                            long long n_vertices, int32_t n_props,
                            float* out) {
    Reader r(path);
    if (!r.ok) return -1;
    if (std::fseek(r.f, (long)data_offset, SEEK_SET) != 0) return -1;
    size_t total = (size_t)n_vertices * (size_t)n_props;
    if (std::fread(out, sizeof(float), total, r.f) != total) return -1;
    return n_vertices;
}

}  // extern "C"
