"""Benchmark workload definitions (data tables).

A copy of ``rich_text_to_image_tpu/evaluation/suites.py``, which the port
may not import; the tests hold the two equal.

Carried over verbatim as *data* so metrics stay comparable with the
reference protocol: color suites and object/base prompts from
evaluation/benchmark_color.py:17-155, style scenes/regions/styles from
evaluation/benchmark_style.py:18-52.
"""

COLORS_COMMON = {
    "brown": [165, 42, 42],
    "red": [255, 0, 0],
    "pink": [253, 108, 158],
    "orange": [255, 165, 0],
    "yellow": [255, 255, 0],
    "purple": [128, 0, 128],
    "green": [0, 128, 0],
    "blue": [0, 0, 255],
    "white": [255, 255, 255],
    "gray": [128, 128, 128],
    "black": [0, 0, 0],
    "crimson": [220, 20, 60],
    "maroon": [128, 0, 0],
    "cyan": [0, 255, 255],
    "azure": [240, 255, 255],
    "turquoise": [64, 224, 208],
    "magenta": [255, 0, 255],
}

COLORS_HTML = {
    "Fire Brick red": [178, 34, 34],
    "Salmon red": [250, 128, 114],
    "Coral orange": [255, 127, 80],
    "Tomato orange": [255, 99, 71],
    "Peach Puff orange": [255, 218, 185],
    "Moccasin orange": [255, 228, 181],
    "Goldenrod yellow": [218, 165, 32],
    "Olive yellow": [128, 128, 0],
    "Gold yellow": [255, 215, 0],
    "Lavender purple": [230, 230, 250],
    "Indigo purple": [75, 0, 130],
    "Thistle purple": [216, 191, 216],
    "Plum purple": [221, 160, 221],
    "Violet purple": [238, 130, 238],
    "Orchid purple": [218, 112, 214],
    "Chartreuse green": [127, 255, 0],
    "Lawn green": [124, 252, 0],
    "Lime green": [50, 205, 50],
    "Forest green": [34, 139, 34],
    "Spring green": [0, 255, 127],
    "Sea green": [46, 139, 87],
    "Sky blue": [135, 206, 235],
    "Dodger blue": [30, 144, 255],
    "Steel blue": [70, 130, 180],
    "Navy blue": [0, 0, 128],
    "Slate blue": [106, 90, 205],
    "Wheat brown": [245, 222, 179],
    "Tan brown": [210, 180, 140],
    "Peru brown": [205, 133, 63],
    "Chocolate brown": [210, 105, 30],
    "Sienna brown": [160, 82, 4],
    "Floral White": [255, 250, 240],
    "Honeydew White": [240, 255, 240],
}

# 50 fixed RGB triplets, prompt pattern "color of RGB values [r, g, b]"
_RGB_TRIPLES = [
    [68, 17, 237], [173, 99, 227], [48, 131, 172], [198, 234, 45],
    [182, 53, 74], [29, 139, 118], [105, 96, 172], [216, 118, 105],
    [88, 119, 37], [189, 132, 98], [78, 174, 11], [39, 126, 109],
    [236, 81, 34], [157, 69, 64], [67, 192, 60], [181, 57, 181],
    [71, 240, 139], [34, 153, 226], [47, 221, 120], [219, 100, 27],
    [228, 168, 120], [195, 31, 8], [84, 142, 64], [104, 120, 31],
    [240, 209, 78], [38, 175, 96], [116, 233, 180], [205, 196, 126],
    [56, 107, 26], [200, 55, 100], [35, 21, 185], [77, 26, 73],
    [216, 185, 14], [53, 21, 50], [222, 80, 195], [103, 168, 84],
    [57, 51, 218], [143, 77, 162], [25, 75, 226], [99, 219, 32],
    [211, 22, 52], [162, 239, 198], [40, 226, 144], [208, 211, 9],
    [231, 121, 82], [108, 105, 52], [105, 28, 226], [31, 94, 190],
    [116, 6, 93], [61, 82, 239],
]
COLORS_RGB = {
    f"color of RGB values [{r}, {g}, {b}]": [r, g, b] for r, g, b in _RGB_TRIPLES
}

COLOR_SUITES = {"common": COLORS_COMMON, "html": COLORS_HTML, "rgb": COLORS_RGB}

OBJECTS = [
    "shirt", "pants", "car", "fruit", "vegetable", "flower",
    "bottle beverage", "plant", "candy", "toy", "gem", "church",
]

BASE_PROMPTS = [
    "a man wearing a shirt",
    "a woman wearing pants",
    "a car in the street",
    "a basket of fruit",
    "a bowl of vegetable",
    "a flower in a vase",
    "a bottle of beverage on the table",
    "a plant in the garden",
    "a candy on the table",
    "a toy on the floor",
    "a gem on the ground",
    "a church with beautiful landscape in the background",
]

STYLE_SCENES = [
    "A garden with a mountain in the distance.",
    "A fountain in front of an castle.",
    "A cat sitting on a meadow.",
    "A lighthouse among the turbulent waves in the night.",
    "A stream train on the mountain side.",
    "A cactus standing in the desert.",
    "A dog sitting on a beach.",
    "A solitary rowboat tethered on a serene pond.",
    "A house on a rocky mountain.",
    "A rustic windmill on a grassy hill.",
]

STYLE_REGIONS = [
    ["garden", "mountain"],
    ["fountain", "castle"],
    ["cat", "meadow"],
    ["lighthouse", "turbulent waves"],
    ["stream train", "mountain side"],
    ["cactus", "desert"],
    ["dog", "beach"],
    ["rowboat", "pond"],
    ["house", "mountain"],
    ["rustic", "hill"],
]

STYLES = [
    "Claud Monet, impressionism, oil on canvas",
    "Ukiyoe",
    "Cyber Punk, futuristic, blade runner, william gibson, trending on artstation hq",
    "Pop Art, masterpiece, andy warhol",
    "Vincent Van Gogh",
    "Pixel Art, 8 bits, 16 bits",
    "Abstract Cubism, Pablo Picasso",
]

NUM_DIFFUSION_STEPS = 41
GUIDANCE_SCALE = 8.5
