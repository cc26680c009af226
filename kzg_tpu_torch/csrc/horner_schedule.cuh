// The programs of K4, of the digit ladder and of the narrow modes of K2 and K7:
// dbl-2009-l, add-2007-bl and madd-2007-bl as stages of chains of Fp operations
// on shared-memory slots of 16 words (see horner.cuh, ladder.cuh, pointwise.cuh,
// madd_multi.cuh).
// Generated by `python -m kzg_tpu_torch.curve.horner_schedule --write`
// from kzg_tpu_torch/curve/horner_schedule.py; do not edit.
//
// An operation is kind | dst << 8 | a << 16 | b << 24, slots dst = a (kind) b:
// kind 0 product, 1 add, 2 sub (mod p).
// Chain i is operations [Chains[i], Chains[i + 1]); stage s is chains
// [Stages[s], Stages[s + 1]).

#pragma once

#include <cstdint>

namespace {

// G1: 14 stages (3 of the doubling, 6 of the addition,
// 5 of the mixed addition), 38 chains, 69 operations.
static __constant__ uint32_t kHornerG1Ops[69] = {
    0x00000b00u, 0x0b0b0c01u, 0x0b0c0c01u, 0x01010d00u, 0x0d0d0e01u, 0x0e0e0f01u,
    0x02011000u, 0x10100201u, 0x0e0e1100u, 0x11111201u, 0x0f001300u, 0x13131401u,
    0x0c0c1500u, 0x14150002u, 0x00131602u, 0x160c1700u, 0x12170102u, 0x02021800u,
    0x05051900u, 0x05021a00u, 0x1a1a1a01u, 0x19001b00u, 0x18031c00u, 0x19051d00u,
    0x18021e00u, 0x1d011f00u, 0x1e042000u, 0x1b1c0902u, 0x09092101u, 0x21212200u,
    0x091a0800u, 0x1f200a02u, 0x0a0a0a01u, 0x091f2300u, 0x22092400u, 0x221b2500u,
    0x0a0a2600u, 0x22232700u, 0x27272701u, 0x25252801u, 0x24260602u, 0x28060602u,
    0x06252902u, 0x290a2a00u, 0x272a0702u, 0x02021800u, 0x18031c00u, 0x001c0902u,
    0x18022b00u, 0x09092100u, 0x21212201u, 0x22222201u, 0x2b042000u, 0x01200a02u,
    0x0a0a0a01u, 0x09020800u, 0x08080801u, 0x09012c00u, 0x22092400u, 0x22002500u,
    0x0a0a2600u, 0x222c2d00u, 0x2d2d2d01u, 0x25252801u, 0x24260602u, 0x28060602u,
    0x06252902u, 0x290a2a00u, 0x2d2a0702u,
};
static __constant__ uint16_t kHornerG1Chains[39] = {
    0, 3, 6, 8, 10, 12, 13, 17, 18, 19, 21, 22, 23, 24, 25, 26,
    27, 29, 30, 31, 33, 34, 35, 36, 37, 39, 45, 46, 48, 49, 52, 55,
    57, 58, 59, 60, 61, 63, 69,
};
static __constant__ uint16_t kHornerG1Stages[15] = {
    0, 3, 6, 7, 10, 14, 17, 21, 25, 26, 27, 29, 33, 37, 38,
};
struct HornerProgG1 {
  static constexpr int kComp = 1, kWarps = 4, kSlots = 46;
  static constexpr int kDblEnd = 3, kAddEnd = 9, kMaddEnd = 14;
  static constexpr int kX = 0, kY = 1, kZ = 2, kX2 = 3, kY2 = 4, kZ2 = 5, kX3 = 6, kY3 = 7, kZ3 = 8, kH = 9, kR = 10;
  __device__ static __forceinline__ uint32_t op(int i) { return kHornerG1Ops[i]; }
  __device__ static __forceinline__ int chain(int i) { return kHornerG1Chains[i]; }
  __device__ static __forceinline__ int stage(int i) { return kHornerG1Stages[i]; }
};

// G2: 30 stages (6 of the doubling, 14 of the addition,
// 10 of the mixed addition), 149 chains, 318 operations.
static __constant__ uint32_t kHornerG2Ops[318] = {
    0x01005a01u, 0x01005b02u, 0x5b5a1600u, 0x16161801u, 0x16181801u, 0x01005c00u,
    0x5c5c1701u, 0x17171901u, 0x17191901u, 0x03025f01u, 0x03026002u, 0x605f1a00u,
    0x1a001c01u, 0x03026100u, 0x61611b01u, 0x1b011d01u, 0x04026600u, 0x05036700u,
    0x03026401u, 0x05046501u, 0x65646800u, 0x67661e02u, 0x1e1e0401u, 0x66681f02u,
    0x671f1f02u, 0x1f1f0501u, 0x1b1a5a01u, 0x1b1a5b02u, 0x5b5a2000u, 0x20202201u,
    0x22222201u, 0x22222201u, 0x1b1a5c00u, 0x5c5c2101u, 0x21212301u, 0x23232301u,
    0x23232301u, 0x1d1c5f01u, 0x1d1c6002u, 0x605f2400u, 0x1d1c6100u, 0x61612501u,
    0x19186401u, 0x19186502u, 0x65642600u, 0x19186600u, 0x66662701u, 0x16242802u,
    0x20282802u, 0x28282801u, 0x28282a01u, 0x2a260002u, 0x00282c02u, 0x17252902u,
    0x21292902u, 0x29292901u, 0x29292b01u, 0x2b270102u, 0x01292d02u, 0x2c185c00u,
    0x2d195d00u, 0x19185a01u, 0x2d2c5b01u, 0x5b5a5e00u, 0x5d5c2e02u, 0x222e0202u,
    0x5c5e2f02u, 0x5d2f2f02u, 0x232f0302u, 0x05045a01u, 0x05045b02u, 0x5b5a3000u,
    0x05045c00u, 0x5c5c3101u, 0x0b0a5f01u, 0x0b0a6002u, 0x605f3200u, 0x0b0a6100u,
    0x61613301u, 0x0a046600u, 0x0b056700u, 0x05046401u, 0x0b0a6501u, 0x65646800u,
    0x67663402u, 0x34343401u, 0x66683502u, 0x67353502u, 0x35353501u, 0x32005c00u,
    0x33015d00u, 0x01005a01u, 0x33325b01u, 0x5b5a5e00u, 0x30066100u, 0x31076200u,
    0x07065f01u, 0x31306001u, 0x605f6300u, 0x320a6600u, 0x330b6700u, 0x0b0a6401u,
    0x33326501u, 0x65646800u, 0x30046b00u, 0x31056c00u, 0x05046901u, 0x31306a01u,
    0x6a696d00u, 0x5d5c3602u, 0x5c5e3702u, 0x5d373702u, 0x62613802u, 0x61633902u,
    0x62393902u, 0x67663a02u, 0x66683b02u, 0x673b3b02u, 0x6c6b3c02u, 0x6b6d3d02u,
    0x6c3d3d02u, 0x3a025c00u, 0x3b035d00u, 0x03025a01u, 0x3b3a5b01u, 0x5b5a5e00u,
    0x3c086100u, 0x3d096200u, 0x09085f01u, 0x3d3c6001u, 0x605f6300u, 0x36381202u,
    0x12124201u, 0x37391302u, 0x13134301u, 0x5d5c3e02u, 0x5c5e3f02u, 0x5d3f3f02u,
    0x62614002u, 0x61634102u, 0x62414102u, 0x43425a01u, 0x43425b02u, 0x5b5a4400u,
    0x43425c00u, 0x5c5c4501u, 0x12346100u, 0x13356200u, 0x35345f01u, 0x13126001u,
    0x605f6300u, 0x3e401402u, 0x14141401u, 0x3f411502u, 0x15151501u, 0x62611002u,
    0x61631102u, 0x62111102u, 0x44125c00u, 0x45135d00u, 0x13125a01u, 0x45445b01u,
    0x5b5a5e00u, 0x44366100u, 0x45376200u, 0x37365f01u, 0x45446001u, 0x605f6300u,
    0x15146401u, 0x15146502u, 0x65644a00u, 0x15146600u, 0x66664b01u, 0x5d5c4602u,
    0x5c5e4702u, 0x5d474702u, 0x62614802u, 0x61634902u, 0x62494902u, 0x48484c01u,
    0x464a0c02u, 0x4c0c0c02u, 0x0c484e02u, 0x49494d01u, 0x474b0d02u, 0x4d0d0d02u,
    0x0d494f02u, 0x463e6100u, 0x473f6200u, 0x3f3e5f01u, 0x47466001u, 0x605f6300u,
    0x62615002u, 0x50505001u, 0x61635102u, 0x62515102u, 0x51515101u, 0x4e145c00u,
    0x4f155d00u, 0x15145a01u, 0x4f4e5b01u, 0x5b5a5e00u, 0x5d5c5202u, 0x50520e02u,
    0x5c5e5302u, 0x5d535302u, 0x51530f02u, 0x05045a01u, 0x05045b02u, 0x5b5a3000u,
    0x05045c00u, 0x5c5c3101u, 0x30065c00u, 0x31075d00u, 0x07065a01u, 0x31305b01u,
    0x5b5a5e00u, 0x30046100u, 0x31056200u, 0x05045f01u, 0x31306001u, 0x605f6300u,
    0x5d5c3802u, 0x00381202u, 0x5c5e3902u, 0x5d393902u, 0x01391302u, 0x62615402u,
    0x61635502u, 0x62555502u, 0x13125a01u, 0x13125b02u, 0x5b5a4200u, 0x42424401u,
    0x44444401u, 0x13125c00u, 0x5c5c4301u, 0x43434501u, 0x45454501u, 0x54086100u,
    0x55096200u, 0x09085f01u, 0x55546001u, 0x605f6300u, 0x12046600u, 0x13056700u,
    0x05046401u, 0x13126501u, 0x65646800u, 0x12026b00u, 0x13036c00u, 0x03026901u,
    0x13126a01u, 0x6a696d00u, 0x62614002u, 0x02401402u, 0x14141401u, 0x61634102u,
    0x62414102u, 0x03411502u, 0x15151501u, 0x67661002u, 0x10101001u, 0x66681102u,
    0x67111102u, 0x11111101u, 0x6c6b5602u, 0x6b6d5702u, 0x6c575702u, 0x44125c00u,
    0x45135d00u, 0x13125a01u, 0x45445b01u, 0x5b5a5e00u, 0x44006100u, 0x45016200u,
    0x01005f01u, 0x45446001u, 0x605f6300u, 0x15146401u, 0x15146502u, 0x65644a00u,
    0x15146600u, 0x66664b01u, 0x44566b00u, 0x45576c00u, 0x57566901u, 0x45446a01u,
    0x6a696d00u, 0x5d5c4602u, 0x5c5e4702u, 0x5d474702u, 0x62614802u, 0x61634902u,
    0x62494902u, 0x6c6b5802u, 0x58585801u, 0x6b6d5902u, 0x6c595902u, 0x59595901u,
    0x48484c01u, 0x464a0c02u, 0x4c0c0c02u, 0x0c484e02u, 0x49494d01u, 0x474b0d02u,
    0x4d0d0d02u, 0x0d494f02u, 0x4e145c00u, 0x4f155d00u, 0x15145a01u, 0x4f4e5b01u,
    0x5b5a5e00u, 0x5d5c5202u, 0x58520e02u, 0x5c5e5302u, 0x5d535302u, 0x59530f02u,
};
static __constant__ uint16_t kHornerG2Chains[150] = {
    0, 5, 9, 13, 16, 17, 18, 21, 23, 26, 32, 37, 40, 42, 45, 47,
    53, 59, 60, 61, 64, 66, 69, 72, 74, 77, 79, 80, 81, 84, 86, 89,
    90, 91, 94, 95, 96, 99, 100, 101, 104, 105, 106, 109, 110, 112, 113, 115,
    116, 118, 119, 121, 122, 123, 126, 127, 128, 131, 133, 135, 136, 138, 139, 141,
    144, 146, 147, 148, 151, 153, 155, 156, 158, 159, 160, 163, 164, 165, 168, 171,
    173, 174, 176, 177, 179, 183, 187, 188, 189, 192, 194, 197, 198, 199, 202, 204,
    207, 210, 212, 213, 214, 217, 218, 219, 222, 224, 227, 228, 230, 235, 239, 240,
    241, 244, 245, 246, 249, 250, 251, 254, 257, 261, 263, 266, 267, 269, 270, 271,
    274, 275, 276, 279, 282, 284, 285, 286, 289, 290, 292, 293, 295, 297, 300, 304,
    308, 309, 310, 313, 315, 318,
};
static __constant__ uint16_t kHornerG2Stages[31] = {
    0, 7, 9, 15, 17, 20, 22, 29, 31, 43, 51, 59, 63, 70, 72, 80,
    84, 89, 91, 94, 96, 98, 104, 108, 119, 125, 136, 142, 144, 147, 149,
};
struct HornerProgG2 {
  static constexpr int kComp = 2, kWarps = 8, kSlots = 110;
  static constexpr int kDblEnd = 6, kAddEnd = 20, kMaddEnd = 30;
  static constexpr int kX = 0, kY = 2, kZ = 4, kX2 = 6, kY2 = 8, kZ2 = 10, kX3 = 12, kY3 = 14, kZ3 = 16, kH = 18, kR = 20;
  __device__ static __forceinline__ uint32_t op(int i) { return kHornerG2Ops[i]; }
  __device__ static __forceinline__ int chain(int i) { return kHornerG2Chains[i]; }
  __device__ static __forceinline__ int stage(int i) { return kHornerG2Stages[i]; }
};

}  // namespace
