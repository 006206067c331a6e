"""The port's model code: every LM family and the paper's CNNs; on a TP
mesh the blocks take the boundary collectives (`dist`)."""
