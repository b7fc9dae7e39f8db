// BaM's row-panel small space (bam_smallspace_panel.cuh) on the (2, 2)
// thread tile: kpad 129-136, 9 rows a block, in its own source so that the
// build compiles it beside the (1, 1) instantiation.
#include "bam_smallspace_panel.cuh"

GSMVI_BAM_PANEL_ENTRY(gsmvi_bam_panel_t22, 2, 2)
