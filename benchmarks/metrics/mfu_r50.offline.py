"""mfu_r50.offline (layer model step (ResNet50)): % of the chips' bf16
tensor-core peak that the window's ResNet50 forward passes reach:
operations counted from the shapes (`yardstick_r50.forward_flops`), times
images a second, over the peak of every chip the cell uses; None off the
card or for another architecture."""
from benchmarks import readers, yardstick, yardstick_r50


def read(run):
    m = run.cell.config['model']
    if not run.on_device or m.get('architecture') != 'resnet50':
        return None
    flops = yardstick_r50.forward_flops(m['output_stride'], *readers.model_hw(run))
    rate = run.frames_done / run.window_s
    return 100.0 * flops * rate / (yardstick.BF16_TENSOR_FLOPS * run.cell.chips)
