"""Row-DFT passes on (re, im) f32 planes."""
