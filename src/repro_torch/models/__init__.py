"""Models of the port: the config schema (:mod:`.config`), shared layers
(:mod:`.layers`), the xLSTM blocks (:mod:`.xlstm`) and the LM that stacks
them (:mod:`.lm`)."""
