"""The yardstick's roofline arithmetic: the bytes a kernel's work must move,
counted from what a cell's inputs fix, and the chip's published peaks. It
imports nothing of the program, so a change to the program's binning or BVH
builder does not move it."""
