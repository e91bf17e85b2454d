"""The plain reference that decides a run's ``correct``.

Plain PyTorch in fp32 (TF32 off) and numpy, written from the published
equations and the configuration file's widths: a decoder-only transformer
and its loss (:mod:`.transformer`), a BLADE-FL training job of plain
gradient descent and FedAvg (:mod:`.fedavg`), and the proof-of-work race,
the digest's fold and the ledger's links (:mod:`.chain`). It imports
nothing of the program under test and takes none of its outputs as
inputs: the benchmark hands it the same weights and tokens it hands the
program, and it reads the program's outputs only to judge them.
"""
