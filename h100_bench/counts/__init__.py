"""Operations and bytes, counted from shapes: a model's forward FLOPs
(``model``, with one module a model family), a kernel's least work (``kernels``), and the chip's peaks
(``peaks``). None of it reads the program."""
