// flash_tc for bf16 operands: the kernel is in flash_tc.cuh. One source per
// dtype, so the two sets of six head-dim instances build in parallel.
#include "flash_tc.cuh"

FLASH_TC_ENTRY(flash_tc_bf16, true)
