// Requested variable columns, passed to a kernel by value (kernels B1
// and B5), so that a launch needs no host-to-device copy of them.
#pragma once

namespace iu {

constexpr int kMaxVarSlots = 64;  // ops/_kernels.MAX_VAR_SLOTS

struct VarSlots {
  int n;
  int s[kMaxVarSlots];
};

// The slots of a host array; n must lie in [0, kMaxVarSlots].
inline VarSlots make_var_slots(const int* host, int n) {
  VarSlots v;
  v.n = n;
  for (int i = 0; i < n; ++i) v.s[i] = host[i];
  return v;
}

}  // namespace iu
