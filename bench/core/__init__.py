"""The yardstick: traffic, weights from the seed, statistics, the device
trace's reduction, operation and byte counts and the chip's peaks.  Nothing
here imports the program."""
