"""Work counts of the port's kernels, from shapes alone: the operations and
bytes that a call's inputs need, the same whatever implements them.  One
module per kernel, named as the kernel's library; :mod:`.peaks` holds the
card's published peaks and the least time that follows."""
