// The CLOSED -> OPEN threshold predicate of the circuit breakers
// (sentinel_tpu/rules/degrade_table.py:trip_condition), shared by the exit
// completions (breaker_on_exits.cu, K7) and the sharded step's breaker
// merge (mesh_merge_breaker.cu, K14). float32 as in JAX: IEEE division, no
// fast math. RT breakers open when the slow ratio exceeds the configured
// ratio, with the ratio == 1.0 boundary opening when the threshold is >= 1
// (ResponseTimeCircuitBreaker.java:120-130); exception ratio compares the
// ratio, exception count the count (ExceptionCircuitBreaker.java:110-134).
// min_request gating is the caller's.

#pragma once

namespace {

constexpr int TRIP_GRADE_RT = 0, TRIP_GRADE_EXCEPTION_RATIO = 1;  // models/constants.py

__device__ __forceinline__ bool trip_condition(int grade, float threshold, float slow_ratio, float bad,
                                               float total) {
  float ratio = __fdiv_rn(bad, fmaxf(total, 1.0f));
  if (grade == TRIP_GRADE_RT) return ratio > slow_ratio || (slow_ratio >= 1.0f && ratio >= 1.0f);
  if (grade == TRIP_GRADE_EXCEPTION_RATIO) return ratio > threshold;
  return bad > threshold;
}

}  // namespace
