// WebP decoder for io/image.py::read_image, bound with ctypes.
//
// It reproduces what PIL returns for np.asarray(Image.open(path)) on a
// WebP file: PIL decodes through libwebp's WebPAnimDecoder (RGBA, not
// premultiplied, default options: fancy upsampling, no dithering) and
// takes RGB, or RGBA where WebPGetFeatures reports alpha.  Written from
// the format's specifications, RFC 6386 (VP8) and RFC 9649 (WebP, VP8L);
// the constant tables are RFC 6386's.
//   - The RIFF container: a simple "VP8 " or "VP8L" file, or "VP8X" with
//     its optional chunks (ICCP, EXIF, XMP and unknown chunks skipped, the
//     first ALPH taken); of an animation the first ANMF frame, placed at
//     its offset on a zero-filled canvas as WebPAnimDecoder places a key
//     frame.
//   - VP8 key frames: the boolean decoder, segment, filter and quantiser
//     headers, token probability updates, intra modes (16x16, B_PRED 4x4
//     with its contexts, chroma) with libwebp's edge samples (127 above,
//     129 on the left, the top-right of the last column replicated),
//     coefficient tokens in one to eight partitions, the dequantisation
//     clamps, the inverse DCT and WHT, and the normal or the simple loop
//     filter in raster order of macroblocks (left edge, inner vertical
//     edges, top edge, inner horizontal edges).
//     Then libwebp's output: the 9-3-3-1 "fancy" chroma upsampler of
//     UpsampleRgbaLinePair and the 14-bit fixed-point YUV -> RGB of
//     VP8YUVToR/G/B.
//   - VP8L: the four transforms, the meta Huffman codes, simple and normal
//     code-length codes, LZ77 with the 120-entry distance map and the colour
//     cache.
//   - ALPH: raw or VP8L-coded alpha (the green channel of a headerless
//     VP8L stream), unfiltered horizontally, vertically or by gradient.
// Refused with a message naming them: inter frames, which libwebp
// refuses too, and whatever libwebp refuses as malformed.
//
// Interface: mods_webp_info(data, n, info[3], err, errlen) fills width,
// height and channels (3 or 4); mods_webp_decode(data, n, out, cap, err,
// errlen) writes (height, width, channels) uint8 pixels.  Both return 0,
// or -1 with a message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw Error{"WebP: " + msg}; }

inline uint32_t le16(const uint8_t *p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t *p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t *p) {
  return le24(p) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ===========================================================================
// VP8 tables (RFC 6386)

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// token probabilities: the update flags' and the defaults
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
         {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
         {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
         {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
         {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
         {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
         {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
         {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
         {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
         {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
         {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
         {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
         {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
         {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
         {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
         {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
         {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
         {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
         {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
         {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
         {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
         {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
         {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
         {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
         {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
         {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
         {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
         {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
         {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
         {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
         {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
         {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
         {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
         {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
         {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
         {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
         {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
         {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
         {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
         {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
         {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
         {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
         {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
         {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
         {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
         {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
         {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
         {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
         {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
         {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
         {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
         {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
         {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
         {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
         {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
         {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};

// [above][left][node]
const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

// intra modes, numbered as the tables are indexed
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED };
// the B_PRED sub-block mode tree: leaves are -mode, node i reads prob[i]
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

// ===========================================================================
// VP8 boolean decoder (RFC 6386 section 7)

struct BoolDecoder {
  const uint8_t *p = nullptr, *end = nullptr;
  uint32_t value = 0, range = 255;
  int bit_count = 0, overrun = 0;

  void init(const uint8_t *s, size_t n) {
    p = s;
    end = s + n;
    value = next() << 8;
    value |= next();
    range = 255;
    bit_count = 0;
  }
  uint32_t next() {
    if (p < end) return *p++;
    ++overrun;
    return 0;
  }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * prob) >> 8);
    const uint32_t big = split << 8;
    int b;
    if (value >= big) {
      b = 1;
      range -= split;
      value -= big;
    } else {
      b = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return b;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit(128);
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return bit(128) ? -v : v;
  }
};

// ===========================================================================
// VP8 key frame -> Y, U, V planes

constexpr int BPS = 32;  // stride of the work buffers

struct FilterInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBContext {
  uint8_t nz = 0, nz_dc = 0;
};

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// 4x4 predictions; dst[-BPS..] is the row above (with the top-left at
// dst[-BPS - 1] and four top-right samples), dst[-1 + y * BPS] the left.
#define DST(x, y) dst[(x) + (y) * BPS]
void pred4(int mode, uint8_t *dst) {
  const uint8_t *top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int y = 0; y < 4; ++y) memset(dst + y * BPS, dc, 4);
      break;
    }
    case B_TM_PRED:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          DST(x, y) = clip8(top[x] + dst[-1 + y * BPS] - top[-1]);
      break;
    case B_VE_PRED: {
      uint8_t v[4];
      for (int i = 0; i < 4; ++i) v[i] = avg3(top[i - 1], top[i], top[i + 1]);
      for (int y = 0; y < 4; ++y) memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst, avg3(A, B, C), 4);
      memset(dst + BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = top[-1], A = top[0], B = top[1],
                C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = top[-1], A = top[0], B = top[1],
                C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
    }
    default:
      fail("corrupt intra mode");
  }
}
#undef DST

// 16x16 (size 16) and 8x8 chroma (size 8) predictions.  The DC mode
// averages only the edges that exist (libwebp's CheckMode).
void pred_block(int mode, uint8_t *dst, int size, bool has_top,
                bool has_left) {
  const uint8_t *top = dst - BPS;
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int v;
      if (has_top && has_left) {
        int dc = 0;
        for (int i = 0; i < size; ++i) dc += top[i] + dst[-1 + i * BPS];
        v = (dc + size) >> (shift + 1);
      } else if (has_top || has_left) {
        int dc = 0;
        for (int i = 0; i < size; ++i)
          dc += has_top ? top[i] : dst[-1 + i * BPS];
        v = (dc + size / 2) >> shift;
      } else {
        v = 0x80;
      }
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
      break;
    }
    case TM_PRED:
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x)
          dst[x + y * BPS] = clip8(top[x] + dst[-1 + y * BPS] - top[-1]);
      break;
    case V_PRED:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, top, size);
      break;
    case H_PRED:
      for (int y = 0; y < size; ++y)
        memset(dst + y * BPS, dst[-1 + y * BPS], size);
      break;
    default:
      fail("corrupt intra mode");
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// inverse DCT of one 4x4 block, added to dst
void idct_add(const int16_t *in, uint8_t *dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

// inverse Walsh-Hadamard transform of the Y2 block into the 16 Y DCs
void iwht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

bool any_nonzero(const int16_t *c) {
  for (int i = 0; i < 16; ++i)
    if (c[i]) return true;
  return false;
}

// ---- the normal loop filter (libwebp's dsp/dec.c, RFC 6386 section 15)

inline int sclamp(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline int sclip1(int v) { return sclamp(v, -128, 127); }  // [-1020, 1020]
inline int sclip2(int v) { return sclamp(v, -16, 15); }    // [-112, 112]

inline void filter2(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t *p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter2(const uint8_t *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter's edge: two taps on each side, luma only
void simple_filter(uint8_t *p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride) {
    const int p1 = p[-2 * hstride], p0 = p[-hstride], q0 = p[0],
              q1 = p[hstride];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= thresh2)
      filter2(p, hstride);
  }
}

// a macroblock edge (six taps) or an inner edge (four taps), `size`
// samples along it: hstride crosses the edge, vstride runs along it
void filter_loop(uint8_t *p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh))
        filter2(p, hstride);
      else if (mb_edge)
        filter6(p, hstride);
      else
        filter4(p, hstride);
    }
    p += vstride;
  }
}

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  // dequantisation per segment: {dc, ac} for Y1, Y2, UV
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];
  BoolDecoder br, parts[8];
  int num_parts = 1;
  BoolDecoder *tokens = parts;

  std::vector<uint8_t> Y, U, V;  // (16 mb_h, 16 mb_w), (8 mb_h, 8 mb_w)
  int ystride = 0, uvstride = 0;

  void parse(const uint8_t *d, size_t n);
  int get_coeffs(int type, int ctx, const int *dq, int n, int16_t *out);
  void decode();
  void filter_mb(const FilterInfo &f, int mb_x, int mb_y);
};

// the frame tag and key-frame header (libwebp's VP8GetInfo): the size,
// and the first partition's length
uint32_t vp8_header(const uint8_t *d, size_t n, int &width, int &height) {
  if (n < 10) fail("the VP8 frame is truncated");
  const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
  const int profile = (bits >> 1) & 7;
  if (bits & 1)
    fail("VP8 inter frames are not supported (libwebp decodes key frames "
         "only)");
  if (profile > 3) fail("unknown VP8 profile " + std::to_string(profile));
  if (!((bits >> 4) & 1)) fail("the VP8 frame is not displayable");
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
    fail("bad VP8 key-frame start code");
  width = le16(d + 6) & 0x3fff;
  height = le16(d + 8) & 0x3fff;
  if (!width || !height) fail("zero VP8 frame size");
  return bits >> 5;
}

void VP8Decoder::parse(const uint8_t *d, size_t n) {
  const uint32_t part0 = vp8_header(d, n, width, height);
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  d += 10;
  n -= 10;
  if (part0 > n) fail("the VP8 first partition is truncated");
  br.init(d, part0);
  br.literal(1);  // colour space
  br.literal(1);  // clamping type
  // segment header
  use_segment = br.literal(1);
  if (use_segment) {
    update_map = br.literal(1);
    if (br.literal(1)) {  // update data
      absolute_delta = br.literal(1);
      for (int s = 0; s < 4; ++s)
        quantizer[s] = br.literal(1) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength[s] = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        seg_probs[s] = br.literal(1) ? br.literal(8) : 255;
  }
  // filter header
  simple = br.literal(1);
  level = br.literal(6);
  sharpness = br.literal(3);
  use_lf_delta = br.literal(1);
  if (use_lf_delta && br.literal(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) mode_lf_delta[i] = br.signed_literal(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // token partitions: the sizes of all but the last, 3 bytes each; a row
  // of macroblocks reads partition mb_y % num_parts (libwebp's
  // ParsePartitions)
  num_parts = 1 << br.literal(2);
  const size_t last = num_parts - 1;
  size_t left = n - part0;
  if (left < 3 * last) fail("the VP8 partition sizes are truncated");
  const uint8_t *sz = d + part0, *start = sz + 3 * last;
  left -= 3 * last;
  for (size_t p = 0; p < last; ++p) {
    const size_t psize = std::min<size_t>(le24(sz + 3 * p), left);
    parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  if (left == 0) fail("the VP8 token partitions are truncated");
  parts[last].init(start, left);
  // quantiser
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.literal(1) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.literal(1) ? br.signed_literal(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q;
    if (use_segment) {
      q = quantizer[s];
      if (!absolute_delta) q += base_q0;
    } else {
      q = base_q0;
    }
    auto at = [](int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; };
    y1[s][0] = kDcTable[at(q + dqy1_dc, 127)];
    y1[s][1] = kAcTable[at(q, 127)];
    y2[s][0] = kDcTable[at(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100, at least 8
    y2[s][1] = (kAcTable[at(q + dqy2_ac, 127)] * 101581) >> 16;
    if (y2[s][1] < 8) y2[s][1] = 8;
    uv[s][0] = kDcTable[at(q + dquv_dc, 117)];
    uv[s][1] = kAcTable[at(q + dquv_ac, 127)];
  }
  br.literal(1);  // refresh entropy probabilities: a key frame only
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                  ? br.literal(8)
                                  : kCoeffsProba0[t][b][c][p];
  use_skip = br.literal(1);
  if (use_skip) skip_p = br.literal(8);
  // filter strengths per segment and B_PRED or not
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo &f = fstrengths[s][i4x4];
      int lv = base_level;
      if (use_lf_delta) {
        lv += ref_lf_delta[0];
        if (i4x4) lv += mode_lf_delta[0];
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        f.ilevel = ilevel;
        f.limit = 2 * lv + ilevel;
        f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      } else {
        f.limit = 0;
      }
      f.inner = i4x4;
    }
  }
}

// one block's tokens (RFC 6386 section 13); returns the index after the
// last coefficient read, as libwebp's GetCoeffs does
int VP8Decoder::get_coeffs(int type, int ctx, const int *dq, int n,
                           int16_t *out) {
  BoolDecoder &b = *tokens;
  const uint8_t *p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!b.bit(p[0])) return n;  // end of block
    while (!b.bit(p[1])) {       // a zero coefficient
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const int band_next = kBands[n + 1];
    if (!b.bit(p[2])) {
      v = 1;
      p = proba[type][band_next][1];
    } else {
      if (!b.bit(p[3])) {
        if (!b.bit(p[4]))
          v = 2;
        else
          v = 3 + b.bit(p[5]);
      } else if (!b.bit(p[6])) {
        if (!b.bit(p[7])) {
          v = 5 + b.bit(159);
        } else {
          v = 7 + 2 * b.bit(165);
          v += b.bit(145);
        }
      } else {
        const int bit1 = b.bit(p[8]);
        const int bit0 = b.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab)
          v += v + b.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = proba[type][band_next][2];
    }
    const int s = b.bit(128) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

void VP8Decoder::filter_mb(const FilterInfo &f, int mb_x, int mb_y) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t *y = &Y[(size_t)mb_y * 16 * ystride + mb_x * 16];
  if (filter_type == 1) {  // simple: luma only
    if (mb_x > 0) simple_filter(y, 1, ystride, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ystride, limit);
    if (mb_y > 0) simple_filter(y, ystride, 1, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4)
        simple_filter(y + k * ystride, ystride, 1, limit);
    return;
  }
  uint8_t *u = &U[(size_t)mb_y * 8 * uvstride + mb_x * 8];
  uint8_t *v = &V[(size_t)mb_y * 8 * uvstride + mb_x * 8];
  const int il = f.ilevel, hv = f.hev_thresh;
  const int ys = ystride, us = uvstride;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
    filter_loop(u, 1, us, 8, limit + 4, il, hv, true);
    filter_loop(v, 1, us, 8, limit + 4, il, hv, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4)
      filter_loop(y + k, 1, ys, 16, limit, il, hv, false);
    filter_loop(u + 4, 1, us, 8, limit, il, hv, false);
    filter_loop(v + 4, 1, us, 8, limit, il, hv, false);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
    filter_loop(u, us, 1, 8, limit + 4, il, hv, true);
    filter_loop(v, us, 1, 8, limit + 4, il, hv, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4)
      filter_loop(y + k * ys, ys, 1, 16, limit, il, hv, false);
    filter_loop(u + 4 * us, us, 1, 8, limit, il, hv, false);
    filter_loop(v + 4 * us, us, 1, 8, limit, il, hv, false);
  }
}

void VP8Decoder::decode() {
  ystride = 16 * mb_w;
  uvstride = 8 * mb_w;
  Y.assign((size_t)ystride * 16 * mb_h, 0);
  U.assign((size_t)uvstride * 8 * mb_h, 0);
  V.assign((size_t)uvstride * 8 * mb_h, 0);
  // work buffers as libwebp's yuv_b_: a row above, four columns left
  uint8_t ywork[BPS * 17], uwork[BPS * 9], vwork[BPS * 9];
  memset(ywork, 0, sizeof(ywork));
  memset(uwork, 0, sizeof(uwork));
  memset(vwork, 0, sizeof(vwork));
  uint8_t *const ydst = ywork + BPS + 8;
  uint8_t *const udst = uwork + BPS + 8;
  uint8_t *const vdst = vwork + BPS + 8;
  // the unfiltered bottom rows of the macroblock row above
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<MBContext> ctx_t(mb_w);
  std::vector<FilterInfo> finfo((size_t)mb_w * mb_h);
  int16_t coeffs[384];

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    tokens = &parts[mb_y & (num_parts - 1)];
    uint8_t intra_l[4];
    memset(intra_l, B_DC_PRED, 4);
    MBContext left;
    // left-most block: 129 on the left, the top-left 129 or 127 above
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
    } else {
      memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      memset(udst - BPS - 1, 127, 8 + 1);
      memset(vdst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      // ---- modes (first partition)
      int segment = 0, skip = 0;
      if (update_map)
        segment = !br.bit(seg_probs[0]) ? br.bit(seg_probs[1])
                                        : br.bit(seg_probs[2]) + 2;
      if (use_skip) skip = br.bit(skip_p);
      const bool is_i4x4 = !br.bit(145);
      uint8_t imodes[16];
      uint8_t *top = &intra_t[4 * mb_x];
      if (!is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                      : (br.bit(163) ? V_PRED : DC_PRED);
        imodes[0] = ymode;
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        uint8_t *modes = imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t *prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            top[x] = ymode;
          }
          memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = ymode;
        }
      }
      const int uvmode = !br.bit(142)   ? DC_PRED
                         : !br.bit(114) ? V_PRED
                         : br.bit(183)  ? TM_PRED
                                        : H_PRED;
      // ---- residuals (token partition)
      MBContext &mb = ctx_t[mb_x];
      memset(coeffs, 0, sizeof(coeffs));
      bool all_zero = true;
      if (!skip) {
        const int s = segment;
        int16_t *dst = coeffs;
        int first, type;
        if (!is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = mb.nz_dc + left.nz_dc;
          const int nz = get_coeffs(1, ctx, y2[s], 0, dc);
          mb.nz_dc = left.nz_dc = (nz > 0);
          iwht(dc, dst);
          first = 1;
          type = 0;
        } else {
          first = 0;
          type = 3;
        }
        uint32_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(type, ctx, y1[s], first, dst);
            l = (nz > first);
            tnz = (tnz >> 1) | (l << 7);
            dst += 16;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
        }
        uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = mb.nz >> (4 + ch);
          lnz = left.nz >> (4 + ch);
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(2, ctx, uv[s], 0, dst);
              l = (nz > 0);
              tnz = (tnz >> 1) | (l << 3);
              dst += 16;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          out_t_nz |= (tnz << 4) << ch;
          out_l_nz |= (lnz & 0xf0) << ch;
        }
        mb.nz = out_t_nz;
        left.nz = out_l_nz;
        for (int i = 0; i < 384 && all_zero; ++i)
          if (coeffs[i]) all_zero = false;
      } else {
        left.nz = mb.nz = 0;
        if (!is_i4x4) left.nz_dc = mb.nz_dc = 0;
      }
      if (filter_type > 0) {
        FilterInfo f = fstrengths[segment][is_i4x4];
        f.inner |= !all_zero;
        finfo[(size_t)mb_y * mb_w + mb_x] = f;
      }
      // ---- reconstruction (libwebp's ReconstructRow)
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          memcpy(&ydst[j * BPS - 4], &ydst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&udst[j * BPS - 4], &udst[j * BPS + 4], 4);
          memcpy(&vdst[j * BPS - 4], &vdst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        memcpy(ydst - BPS, &top_y[16 * mb_x], 16);
        memcpy(udst - BPS, &top_u[8 * mb_x], 8);
        memcpy(vdst - BPS, &top_v[8 * mb_x], 8);
      }
      if (is_i4x4) {
        uint8_t *top_right = ydst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            memset(top_right, top_y[16 * mb_x + 15], 4);
          else
            memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        // the top-right samples of the sub-blocks on the right column
        for (int r = 1; r <= 3; ++r) memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t *dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred4(imodes[n], dst);
          if (any_nonzero(coeffs + n * 16)) idct_add(coeffs + n * 16, dst);
        }
      } else {
        pred_block(imodes[0], ydst, 16, mb_y > 0, mb_x > 0);
        for (int n = 0; n < 16; ++n) {
          uint8_t *dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          if (any_nonzero(coeffs + n * 16)) idct_add(coeffs + n * 16, dst);
        }
      }
      pred_block(uvmode, udst, 8, mb_y > 0, mb_x > 0);
      pred_block(uvmode, vdst, 8, mb_y > 0, mb_x > 0);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        if (any_nonzero(coeffs + 256 + n * 16))
          idct_add(coeffs + 256 + n * 16, udst + off);
        if (any_nonzero(coeffs + 320 + n * 16))
          idct_add(coeffs + 320 + n * 16, vdst + off);
      }
      if (mb_y < mb_h - 1) {
        memcpy(&top_y[16 * mb_x], ydst + 15 * BPS, 16);
        memcpy(&top_u[8 * mb_x], udst + 7 * BPS, 8);
        memcpy(&top_v[8 * mb_x], vdst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(&Y[(size_t)(mb_y * 16 + j) * ystride + mb_x * 16],
               ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&U[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8],
               udst + j * BPS, 8);
        memcpy(&V[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8],
               vdst + j * BPS, 8);
      }
    }
    // libwebp stops at an end of data in either partition
    if (br.overrun > 1 || tokens->overrun > 1)
      fail("the VP8 frame is truncated");
  }
  if (filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(finfo[(size_t)mb_y * mb_w + mb_x], mb_x, mb_y);
}

// ---- libwebp's output stage: YUV -> RGBA with fancy upsampling

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t *rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                      mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

// UpsampleRgbaLinePair: two output rows from two chroma rows, weights
// 9-3-3-1 toward the nearer samples; bottom_y may be null
void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y,
                   const uint8_t *top_u, const uint8_t *top_v,
                   const uint8_t *cur_u, const uint8_t *cur_v,
                   uint8_t *top_dst, uint8_t *bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tlu = top_u[0], tlv = top_v[0], lu = cur_u[0], lv = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2,
              top_dst);
  if (bottom_y)
    yuv_to_rgba(bottom_y[0], (3 * lu + tlu + 2) >> 2, (3 * lv + tlv + 2) >> 2,
                bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int tu = top_u[x], tv = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tlu + tu + lu + u + 8, avg_v = tlv + tv + lv + v + 8;
    const int d12u = (avg_u + 2 * (tu + lu)) >> 3;
    const int d03u = (avg_u + 2 * (tlu + u)) >> 3;
    const int d12v = (avg_v + 2 * (tv + lv)) >> 3;
    const int d03v = (avg_v + 2 * (tlv + v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12u + tlu) >> 1, (d12v + tlv) >> 1,
                top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03u + tu) >> 1, (d03v + tv) >> 1,
                top_dst + (2 * x) * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[2 * x - 1], (d03u + lu) >> 1, (d03v + lv) >> 1,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], (d12u + u) >> 1, (d12v + v) >> 1,
                  bottom_dst + (2 * x) * 4);
    }
    tlu = tu;
    tlv = tv;
    lu = u;
    lv = v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tlu + lu + 2) >> 2,
                (3 * tlv + lv + 2) >> 2, top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgba(bottom_y[len - 1], (3 * lu + tlu + 2) >> 2,
                  (3 * lv + tlv + 2) >> 2, bottom_dst + (len - 1) * 4);
  }
}

// EmitFancyRGB over the whole frame into (height, width, 4) RGBA
void vp8_to_rgba(const VP8Decoder &d, uint8_t *out, int out_stride) {
  const int w = d.width, h = d.height;
  const uint8_t *Y = d.Y.data(), *U = d.U.data(), *V = d.V.data();
  const int ys = d.ystride, us = d.uvstride;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(Y + (size_t)(y + 1) * ys, Y + (size_t)(y + 2) * ys,
                  U + (size_t)k * us, V + (size_t)k * us,
                  U + (size_t)(k + 1) * us, V + (size_t)(k + 1) * us,
                  out + (size_t)(y + 1) * out_stride,
                  out + (size_t)(y + 2) * out_stride, w);
  }
  if (!(h & 1)) {  // the last row of an even height
    const int k = (h - 1) / 2;
    upsample_pair(Y + (size_t)(h - 1) * ys, nullptr, U + (size_t)k * us,
                  V + (size_t)k * us, U + (size_t)k * us, V + (size_t)k * us,
                  out + (size_t)(h - 1) * out_stride, nullptr, w);
  }
}

// ===========================================================================
// VP8L (RFC 9649)

struct LBitReader {
  const uint8_t *d;
  size_t n, pos = 0;
  uint64_t val = 0;
  int nbits = 0;
  bool eos = false;

  LBitReader(const uint8_t *data, size_t size) : d(data), n(size) {}
  void fill() {
    while (nbits <= 56 && pos < n) {
      val |= static_cast<uint64_t>(d[pos++]) << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int k) {
    if (nbits < k) fill();
    return static_cast<uint32_t>(val & ((1ull << k) - 1));
  }
  void skip(int k) {
    if (nbits < k) {
      fill();
      if (nbits < k) {
        eos = true;
        val = 0;
        nbits = 0;
        return;
      }
    }
    val >>= k;
    nbits -= k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

constexpr int kMaxCodeLength = 15;
constexpr int kFastBits = 8;

// a canonical prefix code; codes are read most significant bit first
struct Huffman {
  bool single = false;
  int single_sym = 0;
  int count[kMaxCodeLength + 1] = {0};
  std::vector<int> sorted;
  uint32_t fast[1 << kFastBits];  // (length << 16) | symbol, 0 if longer

  void build(const std::vector<int> &lengths) {
    int num = 0, last = 0;
    for (int i = 0; i <= kMaxCodeLength; ++i) count[i] = 0;
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > kMaxCodeLength) fail("corrupt VP8L prefix code");
      if (lengths[s]) {
        ++count[lengths[s]];
        ++num;
        last = static_cast<int>(s);
      }
    }
    if (num == 1) {  // one symbol: read with no bits
      single = true;
      single_sym = last;
      return;
    }
    // the code must be complete (libwebp's BuildHuffmanTable)
    int open = 1;
    for (int l = 1; l <= kMaxCodeLength; ++l) {
      open = 2 * open - count[l];
      if (open < 0) fail("corrupt VP8L prefix code (oversubscribed)");
    }
    if (open != 0) fail("corrupt VP8L prefix code (incomplete)");
    int offs[kMaxCodeLength + 2];
    offs[1] = 0;
    for (int l = 1; l <= kMaxCodeLength; ++l) offs[l + 1] = offs[l] + count[l];
    sorted.assign(num, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) sorted[offs[lengths[s]]++] = static_cast<int>(s);
    memset(fast, 0, sizeof(fast));
    int code = 0, idx = 0;
    for (int l = 1; l <= kMaxCodeLength; ++l) {
      for (int i = 0; i < count[l]; ++i, ++code, ++idx) {
        if (l <= kFastBits) {
          int rev = 0;
          for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
          for (int k = rev; k < (1 << kFastBits); k += 1 << l)
            fast[k] = (static_cast<uint32_t>(l) << 16) | sorted[idx];
        }
      }
      code <<= 1;
    }
  }

  int read(LBitReader &br) const {
    if (single) return single_sym;
    const uint32_t e = fast[br.peek(kFastBits)];
    if (e) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= kMaxCodeLength; ++l) {
      code |= br.read(1);
      const int c = count[l];
      if (code - first < c) return sorted[index + code - first];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("corrupt VP8L data (no prefix code matches)");
  }
};

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};
// (dx, dy) of the 120 short distance codes
const int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct HTreeGroup {
  Huffman h[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int v = static_cast<int>((c0 >> sh) & 0xff) +
                  static_cast<int>((c1 >> sh) & 0xff) -
                  static_cast<int>((c2 >> sh) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << sh;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (ave >> sh) & 0xff, b = (c2 >> sh) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << sh;
  }
  return out;
}

// predictor `mode` for the pixel with left L and the row above `top`
// (top[-1] top-left, top[1] top-right)
inline uint32_t predict(int mode, uint32_t L, const uint32_t *top) {
  switch (mode) {
    case 0: return 0xff000000u;
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 14 and 15 act as 0 in libwebp
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return (static_cast<int>(pred) * color) >> 5;
}

struct VP8LDecoder {
  LBitReader br;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  VP8LDecoder(const uint8_t *d, size_t n) : br(d, n) {}

  void check() {
    if (br.eos) fail("the VP8L data is truncated");
  }

  void read_code(int alphabet, Huffman &h) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code
      const int num = br.read(1) + 1;
      const int first_len = br.read(1);
      const int s0 = br.read(first_len == 0 ? 1 : 8);
      if (s0 >= alphabet) fail("corrupt VP8L simple code");
      lengths[s0] = 1;
      if (num == 2) {
        const int s1 = br.read(8);
        if (s1 >= alphabet) fail("corrupt VP8L simple code");
        lengths[s1] = 1;
      }
    } else {
      std::vector<int> cl(19, 0);
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
      Huffman lh;
      lh.build(cl);
      int max_symbol;
      if (br.read(1)) {
        const int length_nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_nbits);
        if (max_symbol > alphabet) fail("corrupt VP8L code lengths");
      } else {
        max_symbol = alphabet;
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int code_len = lh.read(br);
        if (code_len < 16) {
          lengths[symbol++] = code_len;
          if (code_len) prev = code_len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int slot = code_len - 16;
          const int repeat = br.read(kExtra[slot]) + kOffset[slot];
          if (symbol + repeat > alphabet) fail("corrupt VP8L code lengths");
          const int v = code_len == 16 ? prev : 0;
          for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
        }
      }
    }
    check();
    h.build(lengths);
  }

  static uint32_t copy_value(int sym, LBitReader &br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const uint32_t offset = (2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  // one image of xsize * ysize ARGB pixels; the main image (level0)
  // reads the transforms first and may use meta prefix codes
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    int width = xsize;
    if (level0) {
      while (br.read(1)) read_transform(width, ysize);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11)
        fail("corrupt VP8L colour cache size");
    }
    // meta prefix codes
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huff_bits = 2 + br.read(3);
      huff_xsize = subsample(width, huff_bits);
      huff_image = decode_stream(huff_xsize, subsample(ysize, huff_bits), false);
      for (auto &g : huff_image) {
        g = (g >> 8) & 0xffff;
        num_groups = std::max<int>(num_groups, g + 1);
      }
    }
    check();
    std::vector<HTreeGroup> groups(num_groups);
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    for (auto &g : groups) {
      read_code(kNumLiteral + kNumLength + cache_size, g.h[0]);
      read_code(256, g.h[1]);
      read_code(256, g.h[2]);
      read_code(256, g.h[3]);
      read_code(kNumDistance, g.h[4]);
    }
    std::vector<uint32_t> cache(cache_size, 0);
    std::vector<uint32_t> px((size_t)width * ysize);
    const size_t total = px.size();
    size_t i = 0;
    int x = 0, y = 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    while (i < total) {
      const HTreeGroup &g =
          huff_bits ? groups[huff_image[(size_t)(y >> huff_bits) * huff_xsize +
                                        (x >> huff_bits)]]
                    : groups[0];
      const int code = g.h[0].read(br);
      if (code < kNumLiteral) {
        const uint32_t red = g.h[1].read(br);
        const uint32_t blue = g.h[2].read(br);
        const uint32_t alpha = g.h[3].read(br);
        const uint32_t argb = (alpha << 24) | (red << 16) | (code << 8) | blue;
        px[i++] = argb;
        insert(argb);
        if (++x >= width) {
          x = 0;
          ++y;
        }
      } else if (code < kNumLiteral + kNumLength) {
        const uint32_t length = copy_value(code - kNumLiteral, br);
        const int dist_sym = g.h[4].read(br);
        const uint32_t dist_code = copy_value(dist_sym, br);
        size_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int dx = kDistanceMap[dist_code - 1][0];
          const int dy = kDistanceMap[dist_code - 1][1];
          const long dd = static_cast<long>(dy) * width + dx;
          dist = dd >= 1 ? static_cast<size_t>(dd) : 1;
        }
        if (dist > i || length > total - i)
          fail("corrupt VP8L data (a copy out of the image)");
        for (uint32_t k = 0; k < length; ++k, ++i) {
          px[i] = px[i - dist];
          insert(px[i]);
        }
        x += length;
        while (x >= width) {
          x -= width;
          ++y;
        }
      } else {
        const int key = code - kNumLiteral - kNumLength;
        if (key >= cache_size) fail("corrupt VP8L data");
        const uint32_t argb = cache[key];
        px[i++] = argb;
        insert(argb);
        if (++x >= width) {
          x = 0;
          ++y;
        }
      }
      check();
    }
    if (level0) {
      for (int t = static_cast<int>(transforms.size()) - 1; t >= 0; --t)
        px = inverse(transforms[t], px);
    }
    return px;
  }

  void read_transform(int &xsize, int ysize) {
    const int type = br.read(2);
    if (seen & (1u << type)) fail("corrupt VP8L data (a transform twice)");
    seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = br.read(3) + 2;
      t.data = decode_stream(subsample(xsize, t.bits), subsample(ysize, t.bits),
                             false);
    } else if (type == 3) {  // colour indexing
      const int num_colors = br.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                       : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      // the palette is coded as deltas; unused entries are transparent black
      t.data.assign(1u << (8 >> bits), 0);
      for (int i = 0; i < num_colors; ++i)
        t.data[i] = i ? add_pixels(pal[i], t.data[i - 1]) : pal[0];
    }
    transforms.push_back(std::move(t));
  }

  static std::vector<uint32_t> inverse(const Transform &t,
                                       std::vector<uint32_t> &in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // add green to red and blue
      for (auto &p : in) {
        const uint32_t g = (p >> 8) & 0xff;
        uint32_t rb = (p & 0x00ff00ffu) + ((g << 16) | g);
        p = (p & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      return std::move(in);
    }
    if (t.type == 0) {  // predictor
      std::vector<uint32_t> &px = in;
      px[0] = add_pixels(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      const int tiles = subsample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t *row = &px[(size_t)y * w];
        const uint32_t *top = row - w;
        const uint32_t *modes = &t.data[(size_t)(y >> t.bits) * tiles];
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
        }
      }
      return std::move(in);
    }
    if (t.type == 1) {  // cross-colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t *row = &in[(size_t)y * w];
        const uint32_t *codes = &t.data[(size_t)(y >> t.bits) * tiles];
        for (int x = 0; x < w; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(code & 0xff);
          const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += color_delta(g2r, green);
          new_red &= 0xff;
          new_blue += color_delta(g2b, green);
          new_blue += color_delta(r2b, static_cast<int8_t>(new_red));
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
        }
      }
      return std::move(in);
    }
    // colour indexing: expand the bundled indices through the palette
    std::vector<uint32_t> out((size_t)w * h);
    const int in_w = subsample(w, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < h; ++y) {
      const uint32_t *src = &in[(size_t)y * in_w];
      uint32_t *dst = &out[(size_t)y * w];
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }
};

struct VP8LInfo {
  int width, height, alpha;
};

VP8LInfo vp8l_header(const uint8_t *d, size_t n) {
  if (n < 5 || d[0] != 0x2f) fail("bad VP8L signature");
  const uint32_t bits = le32(d + 1);
  const int version = bits >> 29;
  if (version != 0) fail("unknown VP8L version " + std::to_string(version));
  return {static_cast<int>(bits & 0x3fff) + 1,
          static_cast<int>((bits >> 14) & 0x3fff) + 1,
          static_cast<int>((bits >> 28) & 1)};
}

std::vector<uint32_t> decode_vp8l(const uint8_t *d, size_t n) {
  const VP8LInfo info = vp8l_header(d, n);
  VP8LDecoder dec(d + 5, n - 5);
  return dec.decode_stream(info.width, info.height, true);
}

// ===========================================================================
// ALPH

void unfilter(int filter, const uint8_t *prev, const uint8_t *in, uint8_t *out,
              int width) {
  if (filter == 0) {
    memmove(out, in, width);
  } else if (filter == 1 || prev == nullptr) {  // horizontal, or a first row
    uint8_t pred = (filter == 1 && prev) ? prev[0] : 0;
    for (int i = 0; i < width; ++i) {
      out[i] = static_cast<uint8_t>(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) out[i] = static_cast<uint8_t>(prev[i] + in[i]);
  } else {  // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int p = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = static_cast<uint8_t>(in[i] + p);
      top_left = top;
      out[i] = left;
    }
  }
}

std::vector<uint8_t> decode_alpha(const uint8_t *d, size_t n, int width,
                                  int height) {
  if (n < 1) fail("empty ALPH chunk");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3;
  const int pre = (d[0] >> 4) & 3, reserved = d[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0) fail("corrupt ALPH header");
  const size_t npx = (size_t)width * height;
  std::vector<uint8_t> raw(npx);
  if (method == 0) {
    if (n - 1 < npx) fail("the ALPH data is truncated");
    memcpy(raw.data(), d + 1, npx);
  } else {
    VP8LDecoder dec(d + 1, n - 1);
    const std::vector<uint32_t> px = dec.decode_stream(width, height, true);
    for (size_t i = 0; i < npx; ++i) raw[i] = (px[i] >> 8) & 0xff;
  }
  // the pre-processing bit asks for nothing: PIL's decode does no alpha
  // dithering
  std::vector<uint8_t> alpha(npx);
  for (int y = 0; y < height; ++y)
    unfilter(filter, y ? &alpha[(size_t)(y - 1) * width] : nullptr,
             &raw[(size_t)y * width], &alpha[(size_t)y * width], width);
  return alpha;
}

// ===========================================================================
// the container

struct Chunk {
  uint32_t tag;
  const uint8_t *data;
  size_t size;
};

constexpr uint32_t fourcc(const char *s) {
  return static_cast<uint32_t>(s[0]) | (static_cast<uint32_t>(s[1]) << 8) |
         (static_cast<uint32_t>(s[2]) << 16) |
         (static_cast<uint32_t>(s[3]) << 24);
}

std::vector<Chunk> chunks(const uint8_t *d, size_t n) {
  std::vector<Chunk> out;
  size_t pos = 0;
  while (pos + 8 <= n) {
    const uint32_t size = le32(d + pos + 4);
    if (size > n - pos - 8) fail("a chunk runs past the end of the file");
    out.push_back({le32(d + pos), d + pos + 8, size});
    pos += 8 + size + (size & 1);
  }
  return out;
}

// a frame: an optional ALPH and a VP8 or VP8L bitstream
struct Frame {
  const uint8_t *alph = nullptr, *bits = nullptr;
  size_t alph_size = 0, bits_size = 0;
  bool lossless = false;
  int width = 0, height = 0, alpha_hint = 0;  // VP8L's alpha_is_used bit
};

void frame_size(Frame &f) {
  if (f.lossless) {
    const VP8LInfo i = vp8l_header(f.bits, f.bits_size);
    f.width = i.width;
    f.height = i.height;
    f.alpha_hint = i.alpha;
  } else {
    vp8_header(f.bits, f.bits_size, f.width, f.height);
  }
}

Frame find_frame(const std::vector<Chunk> &cs) {
  Frame f;
  for (const Chunk &c : cs) {
    if (c.tag == fourcc("ALPH")) {
      if (!f.alph) {
        f.alph = c.data;
        f.alph_size = c.size;
      }
    } else if (c.tag == fourcc("VP8 ") || c.tag == fourcc("VP8L")) {
      f.bits = c.data;
      f.bits_size = c.size;
      f.lossless = c.tag == fourcc("VP8L");
      frame_size(f);
      return f;
    }
  }
  fail("no VP8 or VP8L bitstream");
}

struct Image {
  int width = 0, height = 0, channels = 3;  // the canvas and PIL's mode
  Frame frame;
  int x0 = 0, y0 = 0;  // the frame's offset on the canvas
};

Image parse_file(const uint8_t *d, size_t n) {
  if (n < 20 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WEBP", 4))
    fail("not a RIFF WEBP file");
  const uint32_t riff = le32(d + 4);
  if (riff < 12) fail("corrupt RIFF size");
  if (riff > n - 8) fail("the file is truncated (RIFF size " +
                         std::to_string(riff) + ")");
  const std::vector<Chunk> cs = chunks(d + 12, riff - 4);
  if (cs.empty()) fail("no chunks");
  Image im;
  const uint32_t first = cs[0].tag;
  if (first == fourcc("VP8 ") || first == fourcc("VP8L")) {
    im.frame = find_frame(cs);
    im.width = im.frame.width;
    im.height = im.frame.height;
    im.channels = im.frame.alpha_hint ? 4 : 3;
    return im;
  }
  if (first != fourcc("VP8X"))
    fail("the first chunk is not VP8, VP8L or VP8X (PIL does not open it)");
  if (cs[0].size < 10) fail("corrupt VP8X chunk");
  const uint8_t flags = cs[0].data[0];
  im.width = le24(cs[0].data + 4) + 1;
  im.height = le24(cs[0].data + 7) + 1;
  const bool alpha_flag = flags & 0x10, animated = flags & 0x02;
  if (animated) {
    for (const Chunk &c : cs) {
      if (c.tag != fourcc("ANMF")) continue;
      if (c.size < 16) fail("corrupt ANMF chunk");
      im.x0 = 2 * le24(c.data);
      im.y0 = 2 * le24(c.data + 3);
      const int fw = le24(c.data + 6) + 1, fh = le24(c.data + 9) + 1;
      im.frame = find_frame(chunks(c.data + 16, c.size - 16));
      if (im.frame.width != fw || im.frame.height != fh)
        fail("the ANMF frame size differs from its bitstream's");
      if (im.x0 + fw > im.width || im.y0 + fh > im.height)
        fail("the ANMF frame lies outside the canvas");
      im.channels = alpha_flag ? 4 : 3;
      return im;
    }
    fail("an animation without frames");
  }
  std::vector<Chunk> rest(cs.begin() + 1, cs.end());
  im.frame = find_frame(rest);
  if (im.frame.width != im.width || im.frame.height != im.height)
    fail("the VP8X canvas size differs from the bitstream's");
  // WebPGetFeatures: VP8L's alpha bit, else the VP8X flag or an ALPH chunk
  if (im.frame.lossless)
    im.channels = im.frame.alpha_hint ? 4 : 3;
  else
    im.channels = (alpha_flag || im.frame.alph) ? 4 : 3;
  return im;
}

// the frame as (height, width, 4) RGBA
std::vector<uint8_t> decode_frame(const Frame &f) {
  std::vector<uint8_t> rgba((size_t)f.width * f.height * 4);
  if (f.lossless) {
    const std::vector<uint32_t> px = decode_vp8l(f.bits, f.bits_size);
    for (size_t i = 0; i < px.size(); ++i) {
      rgba[4 * i] = (px[i] >> 16) & 0xff;
      rgba[4 * i + 1] = (px[i] >> 8) & 0xff;
      rgba[4 * i + 2] = px[i] & 0xff;
      rgba[4 * i + 3] = px[i] >> 24;
    }
    return rgba;
  }
  VP8Decoder dec;
  dec.parse(f.bits, f.bits_size);
  dec.decode();
  vp8_to_rgba(dec, rgba.data(), f.width * 4);
  if (f.alph) {
    const std::vector<uint8_t> a = decode_alpha(f.alph, f.alph_size, f.width,
                                                f.height);
    for (size_t i = 0; i < a.size(); ++i) rgba[4 * i + 3] = a[i];
  }
  return rgba;
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int mods_webp_info(const uint8_t *data, int64_t n, int32_t *info,
                              char *err, int errlen) {
  try {
    const Image im = parse_file(data, static_cast<size_t>(n));
    info[0] = im.width;
    info[1] = im.height;
    info[2] = im.channels;
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("WebP: ") + e.what());
  }
  return -1;
}

extern "C" int mods_webp_decode(const uint8_t *data, int64_t n, uint8_t *out,
                                int64_t cap, char *err, int errlen) {
  try {
    const Image im = parse_file(data, static_cast<size_t>(n));
    const int c = im.channels;
    if ((int64_t)im.width * im.height * c > cap)
      throw Error{"WebP: the output buffer is too small"};
    const std::vector<uint8_t> rgba = decode_frame(im.frame);
    memset(out, 0, (size_t)im.width * im.height * c);
    const Frame &f = im.frame;
    for (int y = 0; y < f.height; ++y) {
      uint8_t *o = out + ((size_t)(im.y0 + y) * im.width + im.x0) * c;
      const uint8_t *s = &rgba[(size_t)y * f.width * 4];
      for (int x = 0; x < f.width; ++x)
        for (int k = 0; k < c; ++k) o[x * c + k] = s[x * 4 + k];
    }
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("WebP: ") + e.what());
  }
  return -1;
}
