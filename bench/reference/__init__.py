"""The benchmark's yardstick: the device data generator, the plain
evaluator that decides ``correct``, and the control it must refuse.
Plain PyTorch; imports nothing of the program."""
