// K4's program: dbl-2009-l and add-2007-bl as stages of chains of Fp
// operations on shared-memory slots of 16 words (see horner.cuh).
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

// G1: 9 stages (3 of the doubling), 26 chains, 45 operations.
static __constant__ uint32_t kHornerG1Ops[45] = {
    0x00000b00u, 0x0b0b0c01u, 0x0b0c0c01u, 0x01010d00u, 0x0d0d0e01u, 0x0e0e0f01u,
    0x02011000u, 0x10100201u, 0x0e0e1100u, 0x11111201u, 0x0f001300u, 0x13131401u,
    0x0c0c1500u, 0x14150002u, 0x00131602u, 0x160c1700u, 0x12170102u, 0x02021800u,
    0x05051900u, 0x05021a00u, 0x1a1a1a01u, 0x19001b00u, 0x18031c00u, 0x19051d00u,
    0x18021e00u, 0x1d011f00u, 0x1e042000u, 0x1b1c0902u, 0x09092101u, 0x21212200u,
    0x091a0800u, 0x1f200a02u, 0x0a0a0a01u, 0x091f2300u, 0x22092400u, 0x221b2500u,
    0x0a0a2600u, 0x22232700u, 0x27272701u, 0x25252801u, 0x24260602u, 0x28060602u,
    0x06252902u, 0x290a2a00u, 0x272a0702u,
};
static __constant__ uint16_t kHornerG1Chains[27] = {
    0, 3, 6, 8, 10, 12, 13, 17, 18, 19, 21, 22, 23, 24, 25, 26,
    27, 29, 30, 31, 33, 34, 35, 36, 37, 39, 45,
};
static __constant__ uint16_t kHornerG1Stages[10] = {
    0, 3, 6, 7, 10, 14, 17, 21, 25, 26,
};
struct HornerProgG1 {
  static constexpr int kComp = 1, kWarps = 4, kSlots = 43;
  static constexpr int kDblEnd = 3, kAddEnd = 9;
  static constexpr int kX = 0, kY = 1, kZ = 2, kX2 = 3, kY2 = 4, kZ2 = 5, kX3 = 6, kY3 = 7, kZ3 = 8, kH = 9, kR = 10;
  __device__ static __forceinline__ uint32_t op(int i) { return kHornerG1Ops[i]; }
  __device__ static __forceinline__ int chain(int i) { return kHornerG1Chains[i]; }
  __device__ static __forceinline__ int stage(int i) { return kHornerG1Stages[i]; }
};

// G2: 20 stages (6 of the doubling), 96 chains, 207 operations.
static __constant__ uint32_t kHornerG2Ops[207] = {
    0x01005401u, 0x01005502u, 0x55541600u, 0x16161801u, 0x16181801u, 0x01005600u,
    0x56561701u, 0x17171901u, 0x17191901u, 0x03025901u, 0x03025a02u, 0x5a591a00u,
    0x1a001c01u, 0x03025b00u, 0x5b5b1b01u, 0x1b011d01u, 0x04026000u, 0x05036100u,
    0x03025e01u, 0x05045f01u, 0x5f5e6200u, 0x61601e02u, 0x1e1e0401u, 0x60621f02u,
    0x611f1f02u, 0x1f1f0501u, 0x1b1a5401u, 0x1b1a5502u, 0x55542000u, 0x20202201u,
    0x22222201u, 0x22222201u, 0x1b1a5600u, 0x56562101u, 0x21212301u, 0x23232301u,
    0x23232301u, 0x1d1c5901u, 0x1d1c5a02u, 0x5a592400u, 0x1d1c5b00u, 0x5b5b2501u,
    0x19185e01u, 0x19185f02u, 0x5f5e2600u, 0x19186000u, 0x60602701u, 0x16242802u,
    0x20282802u, 0x28282801u, 0x28282a01u, 0x2a260002u, 0x00282c02u, 0x17252902u,
    0x21292902u, 0x29292901u, 0x29292b01u, 0x2b270102u, 0x01292d02u, 0x2c185600u,
    0x2d195700u, 0x19185401u, 0x2d2c5501u, 0x55545800u, 0x57562e02u, 0x222e0202u,
    0x56582f02u, 0x572f2f02u, 0x232f0302u, 0x05045401u, 0x05045502u, 0x55543000u,
    0x05045600u, 0x56563101u, 0x0b0a5901u, 0x0b0a5a02u, 0x5a593200u, 0x0b0a5b00u,
    0x5b5b3301u, 0x0a046000u, 0x0b056100u, 0x05045e01u, 0x0b0a5f01u, 0x5f5e6200u,
    0x61603402u, 0x34343401u, 0x60623502u, 0x61353502u, 0x35353501u, 0x32005600u,
    0x33015700u, 0x01005401u, 0x33325501u, 0x55545800u, 0x30065b00u, 0x31075c00u,
    0x07065901u, 0x31305a01u, 0x5a595d00u, 0x320a6000u, 0x330b6100u, 0x0b0a5e01u,
    0x33325f01u, 0x5f5e6200u, 0x30046500u, 0x31056600u, 0x05046301u, 0x31306401u,
    0x64636700u, 0x57563602u, 0x56583702u, 0x57373702u, 0x5c5b3802u, 0x5b5d3902u,
    0x5c393902u, 0x61603a02u, 0x60623b02u, 0x613b3b02u, 0x66653c02u, 0x65673d02u,
    0x663d3d02u, 0x3a025600u, 0x3b035700u, 0x03025401u, 0x3b3a5501u, 0x55545800u,
    0x3c085b00u, 0x3d095c00u, 0x09085901u, 0x3d3c5a01u, 0x5a595d00u, 0x36381202u,
    0x12124201u, 0x37391302u, 0x13134301u, 0x57563e02u, 0x56583f02u, 0x573f3f02u,
    0x5c5b4002u, 0x5b5d4102u, 0x5c414102u, 0x43425401u, 0x43425502u, 0x55544400u,
    0x43425600u, 0x56564501u, 0x12345b00u, 0x13355c00u, 0x35345901u, 0x13125a01u,
    0x5a595d00u, 0x3e401402u, 0x14141401u, 0x3f411502u, 0x15151501u, 0x5c5b1002u,
    0x5b5d1102u, 0x5c111102u, 0x44125600u, 0x45135700u, 0x13125401u, 0x45445501u,
    0x55545800u, 0x44365b00u, 0x45375c00u, 0x37365901u, 0x45445a01u, 0x5a595d00u,
    0x15145e01u, 0x15145f02u, 0x5f5e4a00u, 0x15146000u, 0x60604b01u, 0x57564602u,
    0x56584702u, 0x57474702u, 0x5c5b4802u, 0x5b5d4902u, 0x5c494902u, 0x48484c01u,
    0x464a0c02u, 0x4c0c0c02u, 0x0c484e02u, 0x49494d01u, 0x474b0d02u, 0x4d0d0d02u,
    0x0d494f02u, 0x463e5b00u, 0x473f5c00u, 0x3f3e5901u, 0x47465a01u, 0x5a595d00u,
    0x5c5b5002u, 0x50505001u, 0x5b5d5102u, 0x5c515102u, 0x51515101u, 0x4e145600u,
    0x4f155700u, 0x15145401u, 0x4f4e5501u, 0x55545800u, 0x57565202u, 0x50520e02u,
    0x56585302u, 0x57535302u, 0x51530f02u,
};
static __constant__ uint16_t kHornerG2Chains[97] = {
    0, 5, 9, 13, 16, 17, 18, 21, 23, 26, 32, 37, 40, 42, 45, 47,
    53, 59, 60, 61, 64, 66, 69, 72, 74, 77, 79, 80, 81, 84, 86, 89,
    90, 91, 94, 95, 96, 99, 100, 101, 104, 105, 106, 109, 110, 112, 113, 115,
    116, 118, 119, 121, 122, 123, 126, 127, 128, 131, 133, 135, 136, 138, 139, 141,
    144, 146, 147, 148, 151, 153, 155, 156, 158, 159, 160, 163, 164, 165, 168, 171,
    173, 174, 176, 177, 179, 183, 187, 188, 189, 192, 194, 197, 198, 199, 202, 204,
    207,
};
static __constant__ uint16_t kHornerG2Stages[21] = {
    0, 7, 9, 15, 17, 20, 22, 29, 31, 43, 51, 59, 63, 70, 72, 80,
    84, 89, 91, 94, 96,
};
struct HornerProgG2 {
  static constexpr int kComp = 2, kWarps = 8, kSlots = 104;
  static constexpr int kDblEnd = 6, kAddEnd = 20;
  static constexpr int kX = 0, kY = 2, kZ = 4, kX2 = 6, kY2 = 8, kZ2 = 10, kX3 = 12, kY3 = 14, kZ3 = 16, kH = 18, kR = 20;
  __device__ static __forceinline__ uint32_t op(int i) { return kHornerG2Ops[i]; }
  __device__ static __forceinline__ int chain(int i) { return kHornerG2Chains[i]; }
  __device__ static __forceinline__ int stage(int i) { return kHornerG2Stages[i]; }
};

}  // namespace
