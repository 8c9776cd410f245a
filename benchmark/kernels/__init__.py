"""One module a kernel op: the names of the CUDA kernels that implement it,
the shapes one step of a kind calls it at (`calls(model, batch, kind)`,
kind 'r1', 'plain' or 'forward'), and the operations and bytes those
shapes need (`cost(shape, itemsize)`: each input read once, each output
written once). The kernel roofline reads the same work whatever kernel
implements the op."""
